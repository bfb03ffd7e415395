"""Linear algebra (reference: python/paddle/tensor/linalg.py).

Port of ``paddle_tpu/tensor/linalg.py`` onto ``torch.linalg``.
"""
from __future__ import annotations

import torch

from ._util import dims

__all__ = ["norm", "dist", "cross", "cholesky", "cholesky_solve", "inverse",
           "inv", "pinv", "det", "slogdet", "svd", "qr", "eig", "eigh",
           "eigvals", "eigvalsh", "matrix_power", "matrix_rank", "lstsq",
           "solve", "triangular_solve", "multi_dot", "histogram", "bincount",
           "einsum"]


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    d = dims(x, axis)
    if p == "fro" or p is None:
        return torch.sqrt(torch.sum(torch.square(x), dim=d, keepdim=keepdim))
    if p == float("inf") or p == "inf":
        return torch.amax(torch.abs(x), dim=d, keepdim=keepdim)
    if p == float("-inf") or p == "-inf":
        return torch.amin(torch.abs(x), dim=d, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=d, keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=d, keepdim=keepdim) ** (1.0 / p)


def dist(x, y, p=2, name=None):
    return norm(x - y, p=p)


def cross(x, y, axis=9, name=None):
    if axis == 9:  # paddle default: first axis of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=axis)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(x, y, upper=upper)


def inverse(x, name=None):
    return torch.linalg.inv(x)


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def det(x, name=None):
    return torch.linalg.det(x)


def slogdet(x, name=None):
    sign, logabs = torch.linalg.slogdet(x)
    return torch.stack([sign, logabs])


def svd(x, full_matrices=False, name=None):
    return torch.linalg.svd(x, full_matrices=full_matrices)


def qr(x, mode="reduced", name=None):
    return torch.linalg.qr(x, mode=mode)


def eig(x, name=None):
    return torch.linalg.eig(x)


def eigh(x, UPLO="L", name=None):
    return torch.linalg.eigh(x, UPLO=UPLO)


def eigvals(x, name=None):
    return torch.linalg.eigvals(x)


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(x, rtol=tol, hermitian=hermitian)


def lstsq(x, y, rcond=None, driver=None, name=None):
    res = torch.linalg.lstsq(x, y, rcond=rcond, driver=driver)
    return res.solution, res.residuals, res.rank, res.singular_values


def solve(x, y, name=None):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(
        a, y, upper=upper != transpose, unitriangular=unitriangular)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot(list(x))


def histogram(input, bins=100, min=0, max=0, name=None):
    x = input.to(torch.float64) if input.dtype != torch.float64 else input
    if min == 0 and max == 0:
        min, max = float(x.min()), float(x.max())
    return torch.histc(x, bins=bins, min=min, max=max).to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    return torch.bincount(x, weights=weights, minlength=minlength)


def einsum(equation, *operands):
    return torch.einsum(equation, *operands)
