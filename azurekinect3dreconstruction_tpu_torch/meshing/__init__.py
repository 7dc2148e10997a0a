"""Meshing of point clouds: surface sampling, SDF splatting, ball pivoting, Poisson."""
