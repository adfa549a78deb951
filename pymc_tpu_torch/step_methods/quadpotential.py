"""Mass-matrix (quadpotential) objects.

Counterpart of `pymc_tpu/step_methods/quadpotential.py` (reference
pymc/step_methods/hmc/quadpotential.py: quad_potential :40, isquadpotential
:76, QuadPotentialDiagAdapt :335, QuadPotentialDiag :486,
QuadPotentialFullInv :611, QuadPotentialFull :672, QuadPotentialFullAdapt
:722, QuadPotentialSparse :925). The samplers carry the inverse mass as a
plain tensor ((D,) variances or a (D, D) covariance); these classes give
that tensor the reference's object API (velocity, energy, random).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "QuadPotential", "QuadPotentialDiag", "QuadPotentialDiagAdapt",
    "QuadPotentialFull", "QuadPotentialFullInv", "QuadPotentialFullAdapt",
    "QuadPotentialSparse", "quad_potential", "isquadpotential",
]


def _tensor(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64)) if not isinstance(
        x, torch.Tensor) else x


class QuadPotential:
    """The kinetic energy of the inverse mass `inv_mass`."""

    def __init__(self, inv_mass):
        self.inv_mass = _tensor(inv_mass)

    def velocity(self, p):
        if self.inv_mass.ndim == 1:
            return self.inv_mass * p
        return self.inv_mass @ p

    def energy(self, p):
        return 0.5 * torch.sum(p * self.velocity(p))

    def random(self, generator):
        """A momentum ~ N(0, M), M = inv_mass^-1, from `generator` (a
        torch.Generator on inv_mass's device)."""
        D = self.inv_mass.shape[-1]
        z = torch.randn((D,), generator=generator, dtype=self.inv_mass.dtype,
                        device=self.inv_mass.device)
        if self.inv_mass.ndim == 1:
            return z / torch.sqrt(self.inv_mass)
        # inv_mass = L L^T, so L^-T z has covariance inv_mass^-1
        L = torch.linalg.cholesky(self.inv_mass)
        return torch.linalg.solve_triangular(L.T, z[:, None], upper=True)[:, 0]


class QuadPotentialDiag(QuadPotential):
    """A fixed diagonal: `v` are the posterior variances, the inverse mass
    (reference quadpotential.py:486)."""

    def __init__(self, v):
        super().__init__(v)


class QuadPotentialDiagAdapt(QuadPotentialDiag):
    """The starting state of the adapted diagonal; the adaptation itself
    runs in the samplers' Welford windows (sampling/adaptation.py)."""

    def __init__(self, n, initial_mean, initial_diag=None, initial_weight=0, **kwargs):
        super().__init__(torch.ones(n, dtype=torch.float64) if initial_diag is None
                         else initial_diag)
        self.initial_mean = _tensor(initial_mean)
        self.initial_weight = initial_weight


class QuadPotentialFull(QuadPotential):
    """A fixed dense potential: `cov` is the posterior covariance, the
    inverse mass (reference quadpotential.py:672)."""

    def __init__(self, cov):
        super().__init__(cov)


class QuadPotentialFullInv(QuadPotential):
    """A dense potential given the mass matrix itself (reference :611)."""

    def __init__(self, A):
        super().__init__(torch.linalg.inv(_tensor(A)))


class QuadPotentialFullAdapt(QuadPotentialFull):
    """The starting state of the adapted dense potential (see
    sample(mass_matrix="full"))."""

    def __init__(self, n, initial_mean, initial_cov=None, initial_weight=0, **kwargs):
        super().__init__(torch.eye(n, dtype=torch.float64) if initial_cov is None
                         else initial_cov)
        self.initial_mean = _tensor(initial_mean)
        self.initial_weight = initial_weight


class QuadPotentialSparse(QuadPotential):
    """A sparse mass matrix (reference quadpotential.py:925), made dense at
    construction."""

    def __init__(self, A):
        try:  # a scipy.sparse matrix
            A = A.toarray()
        except AttributeError:
            pass
        super().__init__(torch.linalg.inv(_tensor(A)))


def quad_potential(C, is_cov):
    """The potential of C, 1-D or 2-D (reference quadpotential.py:40):
    is_cov says whether C is the covariance (inverse mass) or the mass."""
    C = _tensor(C)
    if C.ndim == 1:
        return QuadPotentialDiag(C if is_cov else 1.0 / C)
    return QuadPotentialFull(C) if is_cov else QuadPotentialFullInv(C)


def isquadpotential(obj):
    return isinstance(obj, QuadPotential)
