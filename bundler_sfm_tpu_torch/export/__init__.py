"""Bundle-file tools: surgery and scene geometry on the host (copies of the
JAX package's), the PMVS / vis.dat exporters (host text) and radial
undistortion (resampling on a device)."""
