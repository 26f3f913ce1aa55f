"""Pure math: quaternions, spherical harmonics, view matrices."""
