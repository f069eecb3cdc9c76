"""Differential evolution on tensors — the global calibration stage (twin of
``pde_tpu/calibrate/de.py``).

scipy's best1bin with dithered mutation in [0.5, 1) and recombination 0.7
(reference: calibration/heston_calibrator.py:416-426).  The whole
population is evaluated as ONE batched objective call per generation; with
a surface axis, the populations of U surfaces are.

Draws come from an explicit ``torch.Generator``, so they differ draw for
draw from the reference's JAX threefry stream; a fixed generator seed gives
a deterministic run.  The reference's ``lax.while_loop`` is a Python loop
here, with one host read of the stop flags per generation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["DEResult", "differential_evolution"]


class DEResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    population: torch.Tensor
    population_energies: torch.Tensor
    n_iter: torch.Tensor


def differential_evolution(
    objective: Callable[[torch.Tensor], torch.Tensor],
    lower: torch.Tensor,
    upper: torch.Tensor,
    generator: torch.Generator,
    x0: torch.Tensor | None = None,
    popsize: int = 15,
    maxiter: int = 100,
    mutation: tuple = (0.5, 1.0),
    recombination: float = 0.7,
    tol: float = 0.0,
    atol: float = 0.0,
    param_tol: float = 0.0,
    stagnation_patience: int = 0,
    stagnation_rtol: float = 1e-2,
    target_energy=0.0,
    n_surfaces: int | None = None,
    shard=None,
) -> DEResult:
    """Global minimization of a BATCHED objective over a box.

    ``objective`` maps a population (npop, dim) -> (npop,) energies.
    ``generator`` lives on the device of ``lower``.  ``x0`` seeds the first
    member.  The stop rules are the reference's, checked before every
    generation (see ``pde_tpu/calibrate/de.py`` for their rationale):

    * energy spread ``std(energies) <= atol + tol * |mean(energies)|``;
    * parameter spread ``std(pop[:, d]) / (upper - lower)[d] <= param_tol``
      for every dimension;
    * ``target_energy`` (0 = off; may be a tensor): best energy at or below;
    * all three only while the mean energy is finite and the best < 1e9;
    * stagnation: ``stagnation_patience`` consecutive generations whose best
      improved by less than ``stagnation_rtol`` relatively (0 = off).

    ``n_surfaces=U`` runs U independent minimizations over the same box as
    one, the way the reference vmaps its ``while_loop``: the objective maps
    (U, npop, dim) -> (U, npop) in one call a generation, ``x0`` is (U, dim)
    or (dim,), ``target_energy`` may be (U,).  Each surface stops by its own
    rules and from then on keeps its population and energies while the
    others go on; the loop ends once every surface has stopped (one host
    read a generation) or at ``maxiter``.  Every result field gains the
    leading U axis, and ``n_iter`` counts each surface's own generations.
    The draws have the (U, npop, ...) shapes, so U = 1 draws exactly what
    the single-surface call draws.

    ``shard`` runs these U surfaces as one rank's part of a larger batch
    (``calibrate/heston._Shard``: the surfaces laid over ranks).  Its draws
    are made for all ``shard.n_surfaces`` surfaces and it keeps the rows
    ``shard.draw_rows`` (an index tensor, one row a local surface), so each
    surface sees the draws it would see in the whole batch;
    ``shard.running(done)`` says whether a surface of any rank is still
    running (one host read and one collective a generation), so every rank
    runs the same generations and the shard's fit equals the whole batch's
    rows.
    """
    if n_surfaces is None:
        res = differential_evolution(
            lambda pop: objective(pop[0])[None], lower, upper, generator,
            x0=x0, popsize=popsize, maxiter=maxiter, mutation=mutation,
            recombination=recombination, tol=tol, atol=atol, param_tol=param_tol,
            stagnation_patience=stagnation_patience, stagnation_rtol=stagnation_rtol,
            target_energy=target_energy, n_surfaces=1)
        return DEResult(*(f[0] for f in res))

    U, dim = n_surfaces, lower.shape[0]
    npop = popsize * dim
    dtype, device = lower.dtype, lower.device

    U_draw = U if shard is None else shard.n_surfaces

    def rows(x):
        return x if shard is None else x[shard.draw_rows]

    def uniform(*shape):
        return rows(torch.rand((U_draw, *shape), generator=generator, dtype=dtype,
                               device=device))

    def randint(low, high):
        return rows(torch.randint(low, high, (U_draw, npop), generator=generator,
                                  device=device))

    def members(pop, idx):
        """pop[u, idx[u, i]] for each surface u: (U, n, dim)."""
        return torch.take_along_dim(pop, idx[..., None], dim=1)

    pop = lower + (upper - lower) * uniform(npop, dim)
    if x0 is not None:
        pop[:, 0] = torch.clamp(x0.to(dtype), lower, upper)
    energies = objective(pop)

    width = torch.clamp_min(upper - lower, 1e-30)
    target = torch.as_tensor(target_energy, dtype=dtype, device=device)

    def converged(pop, energies):
        # a population sitting entirely on an infeasibility penalty plateau
        # (std = 0 at some huge constant) must keep searching, not "converge"
        best = torch.amin(energies, dim=-1)
        mean = torch.mean(energies, dim=-1)
        spread_ok = torch.std(energies, dim=-1, correction=0) <= atol + tol * torch.abs(mean)
        param_ok = torch.all(torch.std(pop, dim=1, correction=0) / width <= param_tol, dim=-1)
        target_ok = (target > 0.0) & (best <= target)
        return (spread_ok | param_ok | target_ok) & torch.isfinite(mean) & (best < 1e9)

    def generation(pop, energies):
        best = members(pop, torch.argmin(energies, dim=-1, keepdim=True))  # (U, 1, dim)
        # dithered mutation factor, one per member (scipy semantics)
        F = mutation[0] + (mutation[1] - mutation[0]) * uniform(npop, 1)
        # two distinct random partners a != b (!= i is not enforced by scipy
        # either for best1bin; collisions just weaken one mutant)
        ia = randint(0, npop)
        ib = (ia + randint(1, npop)) % npop
        mutant = torch.clamp(best + F * (members(pop, ia) - members(pop, ib)), lower, upper)
        # binomial crossover with a guaranteed dimension
        cross = uniform(npop, dim) < recombination
        forced = torch.nn.functional.one_hot(randint(0, dim), dim).bool()
        trial = torch.where(cross | forced, mutant, pop)

        trial_energy = objective(trial)
        improved = trial_energy < energies
        return (torch.where(improved[..., None], trial, pop),
                torch.where(improved, trial_energy, energies))

    stall = torch.zeros((U,), dtype=torch.int64, device=device)
    n_iter = torch.zeros((U,), dtype=torch.int64, device=device)
    done = torch.zeros((U,), dtype=torch.bool, device=device)
    for _ in range(maxiter):
        done = done | converged(pop, energies)
        if stagnation_patience > 0:
            done = done | (stall >= stagnation_patience)
        # the one host read per generation (and, in a shard, one collective)
        if not (shard.running(done) if shard else not bool(torch.all(done))):
            break
        best_prev = torch.amin(energies, dim=-1)
        trial_pop, trial_energies = generation(pop, energies)
        # a stopped surface keeps its state, as under the reference's vmap
        pop = torch.where(done[:, None, None], pop, trial_pop)
        energies = torch.where(done[:, None], energies, trial_energies)
        improved = ((best_prev - torch.amin(energies, dim=-1))
                    > stagnation_rtol * torch.abs(best_prev))
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        n_iter = n_iter + (~done).long()

    ibest = torch.argmin(energies, dim=-1, keepdim=True)
    return DEResult(
        x=members(pop, ibest)[:, 0],
        fun=torch.take_along_dim(energies, ibest, dim=-1)[:, 0],
        population=pop,
        population_energies=energies,
        n_iter=n_iter,
    )
