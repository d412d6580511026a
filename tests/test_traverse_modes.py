"""Mesh traversal backend selection and the wave engine's attribute path.

`auto` resolves to the exact pure-XLA `wave` engine on every backend,
without asking JAX which platform it runs on; removed engine names are
rejected by both the setter and the environment override.
"""

import jax
import numpy as np
import pytest

from raytracer_tpu.math.vec import Vec3, normalize
from raytracer_tpu.ops import traverse
from raytracer_tpu.ops.bvh_traverse import eval_tri_frame
from raytracer_tpu.ops.intersect import Hits
from raytracer_tpu.ops.wave_traverse import interp_tri_attr
from raytracer_tpu.scene.build import MaterialDesc, SceneBuilder
from raytracer_tpu.scene.presets import random_mesh_scene


@pytest.fixture
def mesh_scene():
    scene, _ = random_mesh_scene(300, seed=3)
    return scene


@pytest.fixture
def restore_mode():
    prev = traverse.get_traversal_mode()
    yield
    traverse.set_traversal_mode(prev)


def test_auto_resolves_to_wave_without_platform_lookup(mesh_scene, monkeypatch, restore_mode):
    def no_lookup(*a, **k):
        raise AssertionError("mode resolution must not query the platform")

    monkeypatch.setattr(jax, "default_backend", no_lookup)
    monkeypatch.setattr(jax, "devices", no_lookup)
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    traverse.set_traversal_mode("auto")
    assert traverse._resolved_mode(mesh_scene) == "wave"


@pytest.mark.parametrize("mode", ["wave", "cluster", "bvh", "null"])
def test_explicit_modes_pass_through(mesh_scene, mode, monkeypatch, restore_mode):
    monkeypatch.delenv("RT_TRAVERSAL_MODE", raising=False)
    traverse.set_traversal_mode(mode)
    assert traverse._resolved_mode(mesh_scene) == mode


@pytest.mark.parametrize("mode", ["wave2", "sorted-pallas"])
def test_removed_modes_raise_via_setter(mode, restore_mode):
    with pytest.raises(ValueError, match="not in"):
        traverse.set_traversal_mode(mode)


@pytest.mark.parametrize("mode", ["wave2", "sorted-pallas"])
def test_removed_modes_raise_via_env(mesh_scene, mode, monkeypatch, restore_mode):
    traverse.set_traversal_mode("auto")
    monkeypatch.setenv("RT_TRAVERSAL_MODE", mode)
    with pytest.raises(ValueError, match="RT_TRAVERSAL_MODE"):
        traverse._resolved_mode(mesh_scene)


def _textured_mesh(n_tris=200, seed=0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [
        b.add_material(MaterialDesc(name=f"m{i}", bsdf="diffuse", base_color=(0.5, 0.5, 0.5)))
        for i in range(3)
    ]
    verts = rng.uniform(-2, 2, (3 * n_tris, 3)).astype(np.float32)
    normals = rng.normal(size=(3 * n_tris, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    uvs = rng.uniform(0, 1, (3 * n_tris, 2)).astype(np.float32)
    faces = np.arange(3 * n_tris).reshape(-1, 3)
    mat_ids = rng.choice(mats, n_tris)
    b.add_mesh(verts, faces, normals, uvs, mat_ids)
    scene, _ = b.build()
    return scene


def test_interp_tri_attr_matches_eval_tri_frame():
    scene = _textured_mesh()
    assert scene.clusters.tri_attr is not None
    rng = np.random.default_rng(1)
    n = 512
    n_tris = scene.tris.material_id.shape[0]
    tri = rng.integers(-1, n_tris, n).astype(np.int32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    v = (rng.uniform(0, 1, n) * (1 - u)).astype(np.float32)
    zeros = np.zeros(n, np.float32)
    hits = Hits(t=zeros + 1.0, prim_id=np.full(n, -1, np.int32), tri_id=tri, u=u, v=v)
    o = Vec3(zeros, zeros, zeros)
    d = Vec3(zeros, zeros, zeros + 1.0)
    ref = eval_tri_frame(scene.tris, hits, o, d)
    nx, ny, nz, tu, tv, mat = interp_tri_attr(scene.clusters, tri, u, v)
    got_n = normalize(Vec3(nx, ny, nz), eps=1e-20)
    hit = tri >= 0
    for got, want in ((got_n.x, ref.normal.x), (got_n.y, ref.normal.y),
                      (got_n.z, ref.normal.z), (tu, ref.tex_u), (tv, ref.tex_v)):
        np.testing.assert_allclose(np.asarray(got)[hit], np.asarray(want)[hit], atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(mat)[hit].astype(np.int32), np.asarray(ref.material_id)[hit]
    )
    # miss lanes carry zeros
    for a in (nx, ny, nz, tu, tv, mat):
        assert np.all(np.asarray(a)[~hit] == 0.0)


def test_interp_tri_attr_none_without_table():
    scene = _textured_mesh(20)
    cs = scene.clusters._replace(tri_attr=None)
    z = np.zeros(4, np.float32)
    assert interp_tri_attr(cs, np.zeros(4, np.int32), z, z) is None
