"""Henjou: a physically-based wavefront path tracer in JAX.

A ground-up JAX/XLA rebuild of the capabilities of Henjou Renderer
(kinakomoti-321/Henjou-Renderer, a C++17/CUDA/OptiX 7.7 offline path tracer;
reference layer map in SURVEY.md). The OptiX megakernel becomes a wavefront
integrator over SoA ray batches; GAS/IAS acceleration structures become an
on-device LBVH rebuilt per frame, traversed on the GPU by a CUDA kernel
called through jax.ffi (accel/route.py); the CUDA
BSDF library (Disney BRDF with thin-film interference LUT, minus-IOR
meta-material BTDF, multiple-scattering GGX) becomes a vectorized JAX BSDF
library with NEE/MIS integration; multi-device scaling rides jax.sharding
over a 1-D device mesh (spp sharding with psum accumulation).
"""

__version__ = "0.1.0"
