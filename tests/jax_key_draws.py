"""A draw source for the port's Monte Carlo code that answers with JAX's
own draws (test-side only: only tests may import JAX).

``JaxKey(key)`` mirrors a PRNG key: ``split(n)`` is ``jax.random.split(key,
n)``, and each draw is the ``jax.random`` call the reference makes on that
key, in the dtype asked for, handed to the port as a torch tensor.  The
port splits its source as the reference splits its key (``n_steps`` step
keys, then ``(k_u, k_z)`` per step; ``(k_lms, k_shift)`` for Sobol; one key
per Sobol replicate; ``(k_diff, k_n, k_j)`` per Bates step; ``(k_diff,
k_jump)`` then ``(k_n, k_v, k_z)`` per SVCJ step; ``(k_reg, k_outer,
k_inner)`` for the dual bound; the unsplit key for the multi-asset terminal
normals; one key a local-vol step; ``(k_w, k_b)`` a lifted rough step;
``(k_u, k_z)`` an SLV step; one key an event date, a ``(2, paths)`` normal
each, and ``(k_next, k_draw)`` chains in the Bermudan continuations; a
``(3, paths)`` normal a G2++ step), so a simulation run on
``JaxKey(key)`` sees the draws the reference makes from ``key``.  A
``count`` (``randint``, ``permutation``) answers the reference's ``vmap``
over ``jax.random.split(key, count)``: one draw from each split key, as rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

_JAX_DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _torch(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


class JaxKey:
    def __init__(self, key):
        self.key = key

    def split(self, n):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def uniform(self, shape, dtype, device):
        return _torch(jax.random.uniform(self.key, shape, _JAX_DTYPES[dtype]), dtype, device)

    def normal(self, shape, dtype, device):
        return _torch(jax.random.normal(self.key, shape, _JAX_DTYPES[dtype]), dtype, device)

    def bits(self, shape, device):
        words = np.asarray(jax.random.bits(self.key, shape, jnp.uint32)).astype(np.int64)
        return torch.as_tensor(words, device=device)

    def poisson(self, rate, shape):
        lam = jnp.asarray(rate.detach().cpu().numpy())
        return _torch(jax.random.poisson(self.key, lam, shape), rate.dtype, rate.device)

    def gamma(self, alpha):
        a = jnp.asarray(alpha.detach().cpu().numpy())
        return _torch(jax.random.gamma(self.key, a, dtype=_JAX_DTYPES[alpha.dtype]),
                      alpha.dtype, alpha.device)

    def _each(self, count, draw):
        if count is None:
            return draw(self.key)
        return jax.vmap(draw)(jax.random.split(self.key, count))

    def randint(self, low, high, shape, device, count=None):
        x = self._each(count, lambda k: jax.random.randint(k, tuple(shape), low, high))
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)

    def permutation(self, n, device, count=None):
        x = self._each(count, lambda k: jax.random.permutation(k, n))
        return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)

    def student_t(self, df, shape, dtype, device):
        return _torch(jax.random.t(self.key, df, tuple(shape), _JAX_DTYPES[dtype]), dtype, device)
