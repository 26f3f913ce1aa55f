"""Pure math: quaternions, spherical harmonics, cameras."""

from mtgs_torch.core.quat import (
    quat_to_rotmat,
    rotmat_to_quat,
    quat_mult,
    quat_normalize,
    random_quats,
    slerp,
    rotate_vector_to_vector,
)
from mtgs_torch.core.sh import (
    num_sh_bases,
    rgb_to_sh,
    sh_to_rgb,
    eval_sh,
    sh_basis,
)
from mtgs_torch.core.camera import (
    PinholeCamera,
    world_to_camera,
    camera_to_gsplat_viewmat,
    opencv_to_scene_frame,
)
