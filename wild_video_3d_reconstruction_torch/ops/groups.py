"""Class wrappers over `ops.lie` with the lietorch Python API.

Counterpart of the JAX package's `ops/groups.py`: `SO3`, `SE3`, `RxSO3`
and `Sim3` hold a data tensor and bind `exp / log / inv / mul / act /
matrix / retr`; `stack` joins groups. Plain classes: the JAX package
registers them as pytrees, which PyTorch needs no counterpart of.
"""

from __future__ import annotations

import torch

from . import lie


class _LieGroup:
    """Base wrapper; subclasses bind the functional ops."""

    embedded_dim = None
    manifold_dim = None
    _id = None

    def __init__(self, data):
        self.data = torch.as_tensor(data)

    @property
    def shape(self):
        return self.data.shape[:-1]

    def __getitem__(self, index):
        return type(self)(self.data[index])

    def __repr__(self):
        return f"{type(self).__name__}(shape={tuple(self.shape)})"

    @classmethod
    def Identity(cls, *batch_shape, dtype=torch.float32, device=None):
        if batch_shape and isinstance(batch_shape[0], (tuple, list,
                                                       torch.Size)):
            batch_shape = tuple(batch_shape[0])
        ident = torch.tensor(cls._id, dtype=dtype, device=device)
        return cls(ident.expand(tuple(batch_shape) + (cls.embedded_dim,))
                   .clone())

    @classmethod
    def IdentityLike(cls, G):
        return cls.Identity(G.shape, dtype=G.data.dtype,
                            device=G.data.device)

    def vec(self):
        return self.data

    def matrix(self):
        return self._matrix(self.data)

    def inv(self):
        return type(self)(self._inv(self.data))

    def log(self):
        return self._log(self.data)

    @classmethod
    def exp(cls, xi):
        return cls(cls._exp(xi))

    def retr(self, xi):
        return type(self)(self._mul(self._exp(xi), self.data))

    def mul(self, other):
        return type(self)(self._mul(self.data, other.data))

    def __mul__(self, other):
        if isinstance(other, _LieGroup):
            return self.mul(other)
        other = torch.as_tensor(other)
        if other.shape[-1] == 3:
            return self._act(self.data, other)
        if other.shape[-1] == 4:
            return self._act4(self.data, other)
        raise ValueError("cannot act on a tensor with trailing dim "
                         f"{other.shape[-1]}")

    def act(self, p):
        return self._act(self.data, p)


def _act4_of(act):
    def act4(data, p4):
        return torch.cat([act(data, p4[..., :3]), p4[..., 3:4]], dim=-1)
    return staticmethod(act4)


class SO3(_LieGroup):
    embedded_dim, manifold_dim = 4, 3
    _id = (0, 0, 0, 1)
    _exp = staticmethod(lie.so3_exp)
    _log = staticmethod(lie.so3_log)
    _inv = staticmethod(lie.quat_conj)
    _mul = staticmethod(lie.quat_mul)
    _act = staticmethod(lie.quat_rotate)
    _act4 = _act4_of(lie.quat_rotate)
    _matrix = staticmethod(lie.quat_to_matrix)


class SE3(_LieGroup):
    embedded_dim, manifold_dim = 7, 6
    _id = (0, 0, 0, 0, 0, 0, 1)
    _exp = staticmethod(lie.se3_exp)
    _log = staticmethod(lie.se3_log)
    _inv = staticmethod(lie.se3_inv)
    _mul = staticmethod(lie.se3_mul)
    _act = staticmethod(lie.se3_act)
    _act4 = staticmethod(lie.se3_act4)
    _matrix = staticmethod(lie.se3_matrix)

    def adj(self, a):
        return lie.se3_adj(self.data, a)

    def adjT(self, a):
        return lie.se3_adjT(self.data, a)

    def scale(self, s):
        return SE3(lie.se3_scale(self.data, s))

    def translation(self):
        return self.data[..., :3]

    @classmethod
    def from_matrix(cls, T):
        return cls(lie.se3_from_matrix(T))


class RxSO3(_LieGroup):
    embedded_dim, manifold_dim = 5, 4
    _id = (0, 0, 0, 1, 1)
    _exp = staticmethod(lie.rxso3_exp)
    _log = staticmethod(lie.rxso3_log)
    _inv = staticmethod(lie.rxso3_inv)
    _mul = staticmethod(lie.rxso3_mul)
    _act = staticmethod(lie.rxso3_act)
    _act4 = _act4_of(lie.rxso3_act)

    @staticmethod
    def _matrix(data):
        return lie.quat_to_matrix(data[..., :4]) * data[..., 4:5, None]


class Sim3(_LieGroup):
    embedded_dim, manifold_dim = 8, 7
    _id = (0, 0, 0, 0, 0, 0, 1, 1)
    _exp = staticmethod(lie.sim3_exp)
    _log = staticmethod(lie.sim3_log)
    _inv = staticmethod(lie.sim3_inv)
    _mul = staticmethod(lie.sim3_mul)
    _act = staticmethod(lie.sim3_act)
    _act4 = staticmethod(lie.sim3_act4)
    _matrix = staticmethod(lie.sim3_matrix)

    @classmethod
    def from_se3(cls, X, s=None):
        data = X.data if isinstance(X, SE3) else torch.as_tensor(X)
        return cls(lie.se3_to_sim3(data, s))


def stack(groups, dim=0):
    """lietorch.stack: one group of the stacked data."""
    return type(groups[0])(torch.stack([g.data for g in groups], dim=dim))
