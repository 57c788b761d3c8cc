"""ugrt — differentiable uniform/perspective-grid ray tracing on the GPU (JAX/Pallas).

A from-scratch differentiable ray tracing framework with the capabilities
of the CUDA reference sushruta/uniformgrid-raytracing (EGPGV'10/TVCG'11):
perspective grids for primary rays, spherical light grids for shadow rays,
uniform grids for reflection rays — plus gradients, sharding, and
checkpointing the reference lacks.
"""

__version__ = "0.1.0"
