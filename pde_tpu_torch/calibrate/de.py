"""Differential evolution on tensors — the global calibration stage (twin of
``pde_tpu/calibrate/de.py``).

scipy's best1bin with dithered mutation in [0.5, 1) and recombination 0.7
(reference: calibration/heston_calibrator.py:416-426).  The whole
population is evaluated as ONE batched objective call per generation.

Draws come from an explicit ``torch.Generator``, so they differ draw for
draw from the reference's JAX threefry stream; a fixed generator seed gives
a deterministic run.  The reference's ``lax.while_loop`` is a Python loop
here, with one host read of the stop flag per generation.
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
    """
    dim = lower.shape[0]
    npop = popsize * dim
    dtype, device = lower.dtype, lower.device

    def uniform(shape):
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)

    def randint(low, high, n):
        return torch.randint(low, high, (n,), generator=generator, device=device)

    pop = lower + (upper - lower) * uniform((npop, dim))
    if x0 is not None:
        pop[0] = torch.clamp(x0.to(dtype), lower, upper)
    energies = objective(pop)

    width = torch.clamp_min(upper - lower, 1e-30)
    target = torch.as_tensor(target_energy, dtype=dtype, device=device)

    def converged(pop, energies):
        # a population sitting entirely on an infeasibility penalty plateau
        # (std = 0 at some huge constant) must keep searching, not "converge"
        spread_ok = (torch.std(energies, correction=0)
                     <= atol + tol * torch.abs(torch.mean(energies)))
        param_ok = torch.all(torch.std(pop, dim=0, correction=0) / width <= param_tol)
        target_ok = (target > 0.0) & (torch.min(energies) <= target)
        return ((spread_ok | param_ok | target_ok)
                & torch.isfinite(torch.mean(energies))
                & (torch.min(energies) < 1e9))

    def generation(pop, energies):
        best = pop[torch.argmin(energies)]
        # dithered mutation factor, one per member (scipy semantics)
        F = mutation[0] + (mutation[1] - mutation[0]) * uniform((npop, 1))
        # two distinct random partners a != b (!= i is not enforced by scipy
        # either for best1bin; collisions just weaken one mutant)
        ia = randint(0, npop, npop)
        ib = (ia + randint(1, npop, npop)) % npop
        mutant = torch.clamp(best[None, :] + F * (pop[ia] - pop[ib]), lower, upper)
        # binomial crossover with a guaranteed dimension
        cross = uniform((npop, dim)) < recombination
        forced = torch.nn.functional.one_hot(randint(0, dim, npop), dim).bool()
        trial = torch.where(cross | forced, mutant, pop)

        trial_energy = objective(trial)
        improved = trial_energy < energies
        return (torch.where(improved[:, None], trial, pop),
                torch.where(improved, trial_energy, energies))

    stall = torch.zeros((), dtype=torch.int64, device=device)
    n_iter = 0
    while n_iter < maxiter:
        stop = converged(pop, energies)
        if stagnation_patience > 0:
            stop = stop | (stall >= stagnation_patience)
        if bool(stop):  # the one host read per generation
            break
        best_prev = torch.min(energies)
        pop, energies = generation(pop, energies)
        improved = (best_prev - torch.min(energies)) > stagnation_rtol * torch.abs(best_prev)
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        n_iter += 1

    ibest = torch.argmin(energies)
    return DEResult(
        x=pop[ibest],
        fun=energies[ibest],
        population=pop,
        population_energies=energies,
        n_iter=torch.tensor(n_iter, device=device),
    )
