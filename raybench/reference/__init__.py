"""The plain reference that decides ``correct``: plain PyTorch and numpy,
importing nothing of the program.  It re-derives from the benchmark's own
inputs (scene recipes, transforms, camera parameters, ray pools, seeds)
everything the program's set-up derived: world triangles, rays, orders."""
