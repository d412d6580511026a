"""raytracer_tpu — a differentiable Monte Carlo path tracing framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference CPU
renderer (Witek902/Raytracer): wavefront integrators (PT, PT+MIS, light
tracing, VCM, debug AOVs), flattened SoA scene representation with two-level
BVH, branchless BSDF/light dispatch, counter-based deterministic sampling,
sharded multi-chip rendering via `jax.sharding`, and a differentiable forward
path giving pixel→(material/light/camera) gradients.

Layer map (mirrors SURVEY.md §1, re-expressed for wavefront accelerators):

    render/      frame loop, film accumulation, postprocess, adaptive blocks
    integrators/ path_tracer (naive + MIS), light_tracer, vcm, debug AOVs
    scene/       SoA scene pytrees, camera, host-side builders, BVH build
    ops/         device kernels: intersect, BVH traversal, BSDF, lights,
                 materials, textures
    math/        SoA vector math, sampling, microfacet, fresnel, transforms
    sampler/     counter-based deterministic sample streams (+ Halton)
    color/       sRGB / tonemapping / spectral helpers
    parallel/    device-mesh sharding of the pixel/ray axis
    io/          scene JSON / OBJ / EXR / BMP
    utils/       logging, profiling, counters
"""

__version__ = "0.1.0"
