"""3D transform math with cgmath semantics (PyTorch).

Counterpart of ``kanirenderer_tpu/core/math3d.py``: right-handed view
matrices, the OpenGL-style perspective whose clip z is consumed directly as
depth, and the symmetric ortho cube of the shadow pass.  Matrices are
row-major (4, 4) float32 tensors acting on column vectors.  Every function
works on the device of its tensor inputs.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
F32 = torch.float32


def normalize(v: Tensor) -> Tensor:
    """L2-normalize the last axis (cgmath ``.normalize()``, no epsilon)."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def look_to_rh(eye: Tensor, direction: Tensor, up: Tensor) -> Tensor:
    """cgmath ``Matrix4::look_to_rh`` (reference src/camera.rs:41-54)."""
    f = normalize(direction)
    s = normalize(torch.linalg.cross(f, up))
    u = torch.linalg.cross(s, f)
    rot = torch.stack([s, u, -f])
    m = torch.eye(4, dtype=F32, device=eye.device)
    m[:3, :3] = rot
    m[:3, 3] = -(rot @ eye)
    return m


def look_at_rh(eye: Tensor, center: Tensor, up: Tensor) -> Tensor:
    return look_to_rh(eye, center - eye, up)


def perspective(fovy_rad: Tensor, aspect: float, near: float,
                far: float) -> Tensor:
    """cgmath ``perspective`` with the OpenGL z range
    (reference src/camera.rs:84-88)."""
    f = 1.0 / torch.tan(fovy_rad / 2.0)
    m = torch.zeros((4, 4), dtype=F32, device=fovy_rad.device)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = (2.0 * far * near) / (near - far)
    m[3, 2] = -1.0
    return m


def ortho(left, right, bottom, top, near, far, device=None) -> Tensor:
    """cgmath ``ortho`` (reference src/light.rs:97-100).  The bounds may be
    floats or 0-d tensors on ``device`` (no host round trip)."""
    m = torch.zeros((4, 4), dtype=F32, device=device)
    m[0, 0] = 2.0 / (right - left)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 2] = -2.0 / (far - near)
    m[2, 3] = -(far + near) / (far - near)
    m[3, 3] = 1.0
    return m


def _rotation(rad: Tensor, i: int, j: int) -> Tensor:
    """Rotation by ``rad`` in the (i, j) coordinate plane."""
    c, s = torch.cos(rad), torch.sin(rad)
    m = torch.zeros((3, 3), dtype=F32, device=rad.device)
    k = 3 - i - j
    m[k, k] = 1.0
    m[i, i] = c
    m[i, j] = -s
    m[j, i] = s
    m[j, j] = c
    return m


def rotation_x(rad: Tensor) -> Tensor:
    return _rotation(rad, 1, 2)


def rotation_y(rad: Tensor) -> Tensor:
    return _rotation(rad, 2, 0)


def rotation_z(rad: Tensor) -> Tensor:
    return _rotation(rad, 0, 1)


def rotate_direction_zyx(direction: Tensor, deg_x, deg_y, deg_z) -> Tensor:
    """Apply Rz·Ry·Rx (degrees) to a direction vector, as
    DirectionalLight::rotate_light (reference src/light.rs:112-119)."""
    dev = direction.device
    rx, ry, rz = (fn(torch.deg2rad(torch.as_tensor(d, dtype=F32, device=dev)))
                  for fn, d in ((rotation_x, deg_x), (rotation_y, deg_y),
                                (rotation_z, deg_z)))
    return (rz @ ry @ rx) @ direction


def quat_to_mat3(q: Tensor) -> Tensor:
    """cgmath ``Matrix3::from(Quaternion)`` for q = (x, y, z, w); no
    normalization, so the zero quaternion maps to the identity."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x + x, y + y, z + z
    xx2, yy2, zz2 = x * x2, y * y2, z * z2
    xy2, xz2, yz2 = x * y2, x * z2, y * z2
    sx2, sy2, sz2 = w * x2, w * y2, w * z2
    row0 = torch.stack([1.0 - yy2 - zz2, xy2 - sz2, xz2 + sy2], dim=-1)
    row1 = torch.stack([xy2 + sz2, 1.0 - xx2 - zz2, yz2 - sx2], dim=-1)
    row2 = torch.stack([xz2 - sy2, yz2 + sx2, 1.0 - xx2 - yy2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def instance_to_model_matrix(position: Tensor, rotation_quat: Tensor) -> Tensor:
    """T(position)·R(quat), batched over leading dims
    (reference src/model.rs:271-278)."""
    rot3 = quat_to_mat3(rotation_quat)
    m = torch.zeros(rot3.shape[:-2] + (4, 4), dtype=F32, device=rot3.device)
    m[..., :3, :3] = rot3
    m[..., :3, 3] = position
    m[..., 3, 3] = 1.0
    return m


def camera_forward(yaw: Tensor, pitch: Tensor) -> Tensor:
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return normalize(torch.stack([cp * cy, sp, cp * sy]))


def camera_view_matrix(position: Tensor, yaw: Tensor, pitch: Tensor) -> Tensor:
    """Camera::calc_matrix (reference src/camera.rs:41-54)."""
    up = torch.tensor([0.0, 1.0, 0.0], dtype=F32, device=position.device)
    return look_to_rh(position, camera_forward(yaw, pitch), up)


def directional_light_view_projection(light_direction: Tensor,
                                      distance: Tensor,
                                      shadow_scene_size) -> Tensor:
    """Light view-projection of the shadow pass
    (reference src/light.rs:80-110): eye at ``dir·distance`` looking at the
    origin, symmetric ortho cube ±shadow_scene_size."""
    dev = light_direction.device
    d = normalize(light_direction)
    target = d * distance
    view = look_at_rh(target, torch.zeros(3, dtype=F32, device=dev),
                      torch.tensor([0.0, 1.0, 0.0], dtype=F32, device=dev))
    s = torch.as_tensor(shadow_scene_size, dtype=F32, device=dev)
    return ortho(-s, s, -s, s, -s, s, device=dev) @ view


def transform_points_h(m: Tensor, pts: Tensor) -> Tensor:
    """(4, 4) @ [p, 1] for (..., 3) points → (..., 4)."""
    return pts @ m[:, :3].T + m[:, 3]
