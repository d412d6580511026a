"""Multi-device rendering: shard the pixel axis over a device mesh.

The reference's only concurrency boundary is a shared-memory thread pool over
image tiles (`Core/Utils/ThreadPool.h:16-58`, `Viewport.cpp:227-261`).  The
device equivalent (SURVEY §2.9 P3):

- 1-D mesh axis ``"tiles"`` over all devices (extendable to ("hosts",
  "chips") with `jax.distributed` multi-controller init);
- the scene pytree (BVH + triangles + materials + lights ≈ tens of MB) is
  REPLICATED per device — it fits device memory easily, like the reference
  keeping the scene shared across threads;
- the film is SHARDED by pixel rows; each device renders and accumulates its
  own band, so a render pass needs NO collectives at all (film reduction is
  free: accumulation is local);
- scene-parameter gradients (differentiable rendering) are partial sums per
  device; `shard_map` + `psum` over "tiles" reduces them (NCCL over NVLink
  on GPUs) — the analogue of merging per-thread contexts
  (`Viewport.cpp:282-287`);
- per-device sample streams need no coordination: samples are pure hashes of
  *global* pixel id, so N-chip and 1-chip renders are bit-identical.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrators.path_tracer import RenderParams, trace_radiance
from ..render.film import Film
from ..render.renderer import ViewportParams, trace_rows
from ..scene.camera import Camera
from ..scene.types import SceneData, SceneMeta

AXIS = "tiles"
HOST_AXIS = "hosts"
CHIP_AXIS = "chips"


def make_mesh(devices=None) -> Mesh:
    """1-D device mesh over the pixel-band axis."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(devices, (AXIS,))


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-controller runtime init (SURVEY §2.9 backend row).

    One call per host process before any jax computation.  On clusters whose
    scheduler JAX recognises the arguments are auto-detected from the
    environment; pass them explicitly otherwise (incl. the CPU multiprocess
    dryrun, tests/test_multihost.py).  Collectives then ride NVLink within a
    host and the network across hosts — the distributed analogue of the
    reference's single-process ThreadPool (`Core/Utils/ThreadPool.h:16-58`)."""
    # NOTE: must not touch the backend here (jax.devices()/process_count()
    # would initialise XLA and make distributed init impossible)
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def make_multihost_mesh(devices=None) -> Mesh:
    """("hosts", "chips") mesh: the outer axis crosses host boundaries (the
    network), the inner axis stays within a host (NVLink).  Shardings that
    keep heavy collectives on the inner axis (photon all_gathers, film psums)
    stay on NVLink; only the final cross-host reductions touch the network."""
    import numpy as np

    devices = list(devices) if devices is not None else list(jax.devices())
    by_proc = {}
    for d in devices:
        by_proc.setdefault(d.process_index, []).append(d)
    procs = sorted(by_proc)
    per = len(by_proc[procs[0]])
    assert all(len(by_proc[p]) == per for p in procs), "uneven devices per host"
    grid = np.array([by_proc[p] for p in procs], dtype=object)
    return Mesh(grid, (HOST_AXIS, CHIP_AXIS))


def _mesh_axes(mesh: Mesh) -> tuple:
    return tuple(mesh.axis_names)


def _flat_index(mesh: Mesh):
    """Linear device index across (possibly several) mesh axes, row-major."""
    axes = _mesh_axes(mesh)
    idx = jax.lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
    return idx


def film_sharding(mesh: Mesh) -> Film:
    """Sharding pytree for a Film: images sharded by rows, counters replicated."""
    axes = _mesh_axes(mesh)
    img = NamedSharding(mesh, P(axes, None, None))
    rep = NamedSharding(mesh, P())
    return Film(sum=img, secondary_sum=img, num_passes=rep, num_secondary_passes=rep)


def render_pass_sharded(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    film: Film,
    pass_idx: jnp.ndarray,
    halton,
    vp: ViewportParams,
    params: RenderParams,
    mesh: Mesh,
):
    """One accumulation pass with the pixel-row axis sharded over ``mesh``.

    Each device traces its own horizontal band (static shapes; band height =
    H / n_devices) and accumulates into its local film shard.  No collective
    is emitted — the interconnect stays free for gradient psums in the
    training path.
    """
    axes = _mesh_axes(mesh)
    n_dev = mesh.devices.size
    assert vp.height % n_dev == 0, f"height {vp.height} % devices {n_dev} != 0"
    rows_per = vp.height // n_dev
    film_spec = Film(P(axes, None, None), P(axes, None, None), P(), P())
    has_halton = halton is not None
    halton_operands = (halton,) if has_halton else ()
    halton_specs = (P(),) if has_halton else ()

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), film_spec, P()) + halton_specs,
        out_specs=(film_spec, P()),
        check_vma=False,
    )
    def shard_fn(scene, cam, film_shard, pass_idx, *maybe_halton):
        band = _flat_index(mesh)
        row0 = band * rows_per
        h = maybe_halton[0] if maybe_halton else None
        radiance, counters = trace_rows(
            scene, meta, cam, pass_idx, h, vp, params, rows=rows_per, row0=row0
        )
        frame = jnp.stack(
            [
                radiance.x.reshape(rows_per, vp.width),
                radiance.y.reshape(rows_per, vp.width),
                radiance.z.reshape(rows_per, vp.width),
            ],
            axis=-1,
        )
        use_secondary = pass_idx % 2 == 0
        film_out = Film(
            sum=film_shard.sum + frame,
            secondary_sum=jnp.where(use_secondary, film_shard.secondary_sum + frame, film_shard.secondary_sum),
            num_passes=film_shard.num_passes + 1,
            num_secondary_passes=film_shard.num_secondary_passes + use_secondary.astype(jnp.int32),
        )
        # whole-frame ray accounting (the reference merges per-thread counters
        # after each pass, `Viewport.cpp:282-287`); one psum
        counters = jax.tree.map(lambda c: jax.lax.psum(c, axes), counters)
        return film_out, counters

    return shard_fn(scene, cam, film, pass_idx, *halton_operands)


def render_pass_vcm_sharded(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    film: Film,
    pass_idx: jnp.ndarray,
    vp: ViewportParams,
    params: RenderParams,
    mesh: Mesh,
    vcm=None,
):
    """One VCM pass with light+camera paths sharded over the pixel-band axis
    (SURVEY §2.9 P4): each device traces its band's sub-paths, photons are
    `all_gather`ed across devices before the (per-device) grid build, and the
    light-tracing splat frame is `psum`med — the hardware analogue of the
    reference's per-thread photon-list concat + single-threaded grid build
    (`VertexConnectionAndMerging.cpp:140-170`)."""
    from ..integrators.vcm import VcmParams, render_pass_vcm

    vcm = vcm if vcm is not None else VcmParams()
    axes = _mesh_axes(mesh)
    n_dev = mesh.devices.size
    assert vp.height % n_dev == 0, f"height {vp.height} % devices {n_dev} != 0"
    rows_per = vp.height // n_dev
    film_spec = Film(P(axes, None, None), P(axes, None, None), P(), P())

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), film_spec, P()),
        out_specs=film_spec,
        check_vma=False,
    )
    def shard_fn(scene, cam, film_shard, pass_idx):
        band = _flat_index(mesh)
        row0 = band * rows_per
        return render_pass_vcm(
            scene, meta, cam, film_shard, pass_idx, None, vp, params, vcm,
            rows=rows_per, row0=row0, axis_name=axes if len(axes) > 1 else axes[0],
        )

    return shard_fn(scene, cam, film, pass_idx)


def train_step_sharded(
    scene: SceneData,
    meta: SceneMeta,
    cam: Camera,
    target: jnp.ndarray,  # (H, W, 3) reference image
    pass_idx: jnp.ndarray,
    vp: ViewportParams,
    params: RenderParams,
    mesh: Mesh,
):
    """Differentiable-rendering step: per-device band loss, psum'd gradients.

    Returns (loss, grads w.r.t. (base_color, emission, roughness)) — the
    pattern for inverse rendering at scale: forward+backward wavefront per
    band, gradient reduction across devices (the 'merge per-thread results'
    analogue, `Viewport.cpp:282-287`)."""
    axes = _mesh_axes(mesh)
    n_dev = mesh.devices.size
    rows_per = vp.height // n_dev

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axes, None, None), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def shard_fn(scene, cam, target_band, pass_idx):
        band = _flat_index(mesh)
        row0 = band * rows_per

        def loss_fn(mat_params):
            base_color, emission, roughness = mat_params
            materials = scene.materials._replace(
                base_color=base_color, emission=emission, roughness=roughness
            )
            s = scene._replace(materials=materials)
            radiance, _ = trace_rows(
                s, meta, cam, pass_idx, None, vp, params, rows=rows_per, row0=row0
            )
            img = jnp.stack(
                [
                    radiance.x.reshape(rows_per, vp.width),
                    radiance.y.reshape(rows_per, vp.width),
                    radiance.z.reshape(rows_per, vp.width),
                ],
                axis=-1,
            )
            # local sum-of-squares; normalized by the GLOBAL pixel count
            return jnp.sum((img - target_band) ** 2) / (vp.width * vp.height * 3)

        # differentiable material parameters only (int kind/texture ids are
        # discrete structure)
        m = scene.materials
        loss, grads = jax.value_and_grad(loss_fn)((m.base_color, m.emission, m.roughness))
        loss = jax.lax.psum(loss, axes)
        grads = jax.lax.psum(grads, axes)
        return loss, grads

    return shard_fn(scene, cam, target, pass_idx)
