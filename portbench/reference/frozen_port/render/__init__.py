"""Render path: BVH refit, camera rays, shading, IBL, composite, cluster
raster (K1) and the hybrid ray-traced frame."""
