"""Quaternion algebra on tensors (reference `utils/quaternion.py`; the port
of `conductor_tpu/t2m/quaternion.py`).

Every function takes tensors whose last dimension is 4 (w, x, y, z), or 3
for vectors, broadcasts over the leading dimensions and computes on the
device and in the dtype of its input (float32 throughout the t2m stack, as
JAX's runs with x64 off).
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / _norm(q)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (inverse for unit quaternions), `quaternion.py:16-21`."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r (`quaternion.py:33-51`)."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by unit quaternions q (..., 4)
    (`quaternion.py:54-73`), via the Rodrigues form."""
    qvec = q[..., 1:]
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2 * (q[..., :1] * uv + uuv)


def qeuler(q: torch.Tensor, order: str = "zyx", epsilon: float = 0.0,
           deg: bool = True) -> torch.Tensor:
    """Quaternion -> Euler angles in the given order (`quaternion.py:76-125`);
    the arcsine's argument clipped to [-1 + epsilon, 1 - epsilon]."""
    w, x, y, z = q.unbind(-1)

    def asin(a):
        return torch.asin(torch.clamp(a, -1 + epsilon, 1 - epsilon))

    if order == "xyz":
        e = (
            torch.atan2(2 * (x * w - y * z), 1 - 2 * (x * x + y * y)),
            asin(2 * (x * z + y * w)),
            torch.atan2(2 * (z * w - x * y), 1 - 2 * (y * y + z * z)),
        )
    elif order == "yzx":
        e = (
            torch.atan2(2 * (x * w - y * z), 1 - 2 * (x * x + z * z)),
            torch.atan2(2 * (y * w - x * z), 1 - 2 * (y * y + z * z)),
            asin(2 * (x * y + z * w)),
        )
    elif order == "zxy":
        e = (
            asin(2 * (x * w + y * z)),
            torch.atan2(2 * (y * w - z * x), 1 - 2 * (x * x + y * y)),
            torch.atan2(2 * (z * w - x * y), 1 - 2 * (x * x + z * z)),
        )
    elif order == "xzy":
        e = (
            torch.atan2(2 * (x * w + y * z), 1 - 2 * (x * x + z * z)),
            torch.atan2(2 * (y * w + x * z), 1 - 2 * (y * y + z * z)),
            asin(2 * (z * w - x * y)),
        )
    elif order == "yxz":
        e = (
            asin(2 * (x * w - y * z)),
            torch.atan2(2 * (x * z + y * w), 1 - 2 * (x * x + y * y)),
            torch.atan2(2 * (x * y + z * w), 1 - 2 * (x * x + z * z)),
        )
    elif order == "zyx":
        e = (
            torch.atan2(2 * (x * w + y * z), 1 - 2 * (x * x + y * y)),
            asin(2 * (y * w - x * z)),
            torch.atan2(2 * (x * y + z * w), 1 - 2 * (y * y + z * z)),
        )
    else:
        raise ValueError(f"unknown euler order {order!r}")
    e = torch.stack(e, dim=-1)
    return torch.rad2deg(e) if deg else e


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Enforce quaternion continuity along the time axis (axis 0)
    (`quaternion.py:149-166`): frame t is flipped when an odd number of the
    dot products between the *original* successive frames up to t are
    negative."""
    dots = (q[1:] * q[:-1]).sum(-1)
    flips = torch.cumsum(dots < 0, dim=0) % 2
    signs = torch.cat([torch.ones_like(flips[:1]), 1 - 2 * flips], dim=0)
    return q * signs.to(q.dtype)[..., None]


def euler2quat(e: torch.Tensor, order: str = "zyx", deg: bool = True) -> torch.Tensor:
    """Euler angles -> quaternion (`quaternion.py:169-211`): the product of
    one rotation an axis, in ``order``."""
    if deg:
        e = torch.deg2rad(e)
    half = e / 2
    q = None
    for i, axis in enumerate(order):
        c, s = torch.cos(half[..., i]), torch.sin(half[..., i])
        zeros = torch.zeros_like(c)
        qa = torch.stack([c, *(s if a == axis else zeros for a in "xyz")], dim=-1)
        q = qa if q is None else qmul(q, qa)
    return q


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle exponential map -> quaternion (`quaternion.py:214-230`)."""
    theta = _norm(e)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / torch.pi) * e
    return torch.cat([w, xyz], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrices (`quaternion.py:274-300`)."""
    w, x, y, z = qnormalize(q).unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """The first two rotation-matrix columns, the continuous 6-D
    representation (`quaternion.py:308-317`)."""
    m = quaternion_to_matrix(q)
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def cont6d_to_matrix(cont6d: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt the 6-D representation back to rotation matrices
    (`quaternion.py:320-336`)."""
    x = cont6d[..., :3]
    y = cont6d[..., 3:]
    x = x / _norm(x)
    z = _cross(x, y)
    z = z / _norm(z)
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def qpow(q: torch.Tensor, t) -> torch.Tensor:
    """Quaternion power by scaling the axis-angle (`quaternion.py:344-366`)."""
    q = qnormalize(q)
    theta = torch.acos(torch.clamp(q[..., :1], -1.0, 1.0))
    axis = q[..., 1:] / torch.clamp(torch.sin(theta), min=1e-9)
    t_theta = torch.as_tensor(t, dtype=q.dtype, device=q.device) * theta
    return torch.cat([torch.cos(t_theta), axis * torch.sin(t_theta)], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation q0 -> q1 along the shorter arc
    (`quaternion.py:369-384`)."""
    q0, q1 = qnormalize(q0), qnormalize(q1)
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    return qmul(q0, qpow(qmul(qinv(q0), q1), t))


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The smallest rotation taking v0 to v1 (`quaternion.py:387-409`)."""
    v = _cross(v0, v1)
    w = torch.sqrt((v0 ** 2).sum(-1, keepdim=True) * (v1 ** 2).sum(-1, keepdim=True)) + (
        v0 * v1).sum(-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def lerp(p0, p1, t):
    return p0 + torch.as_tensor(t, dtype=p0.dtype, device=p0.device) * (p1 - p0)
