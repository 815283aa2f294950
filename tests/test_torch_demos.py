"""The port's demo gallery (messyerraytracer_tpu_torch/demos/run_demos.py)
on the CPU at a small size: every demo of the JAX package's
demos/run_demos.py runs, writes its images as H x W x 3 uint8 PPMs and
prints the JAX demo's HUD keys; the example and probe casts and the layer
demo's two masked casts are held against the JAX package's brute oracle
(core/brute.py) on the same triangles and rays: prim_id and hit counts
exact, distances within the parity rtol 1e-5.

The JAX demos themselves are not run: at this size each takes 26-58 s of
interpret-mode Pallas compilation on the CPU."""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import np_of  # noqa: E402

from messyerraytracer_tpu_torch.demos import run_demos  # noqa: E402

SIZES = {"W": 32, "H": 24, "GI_W": 24, "GI_H": 18, "GI_SPP": 1}

# the keys of each JAX demo's HUD line (demos/run_demos.py:78-359); the
# other demos print none
HUD_KEYS = {
    "raytracer": ("tri/ray=", "hit_rate=", "elapsed=", "ms"),
    "renderer": ("timings: {", "'raygen_ms'", "'trace_ms'", "'shadow_ms'",
                 "'shade_ms'"),
    "layer": ("layer1 hits=", "layer2 hits="),
    "probe": ("probe at z=4.0: hit=", "probe at z=2.0: hit=",
              "probe at z=0.5: hit=", "distance=", "stats: {",
              "'rays_cast'", "'hit_rate'"),
    "gi_comparison": ("1spp 24x18 in ",),
    "example": ("cast_ray -> {hit: ", "distance: ", "prim_id: "),
}
# the PPMs each demo writes, as the JAX demo does, and their (H, W)
IMAGES = {
    "raytracer": {"raytracer": (48, 64)},
    "renderer": {"renderer": (24, 32)},
    "lighting": {"lighting": (24, 32)},
    "pbr": {"pbr": (24, 32)},
    "normal_map": {"normal_map_normals": (24, 32), "normal_map": (24, 32)},
    "panorama": {"panorama": (24, 32)},
    "layer": {"layer": (24, 32)},
    "probe": {},
    "gi_comparison": {"gi_comparison": (18, 24)},
    "rt_graphics": {"rt_graphics": (24, 32)},
    "example": {},
}


@pytest.fixture(scope="module")
def gallery(tmp_path_factory):
    """Every demo run once on the CPU at the test size: {name: (result,
    paths written, printed text)}, and the layer demo's rays."""
    out = tmp_path_factory.mktemp("demos")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(run_demos, "OUT", str(out))
        for k, v in SIZES.items():
            mp.setattr(run_demos, k, v)
        for name in run_demos.DEMOS:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res, paths = run_demos.run_demo(name, "cpu")
            runs[name] = (res, paths, buf.getvalue())
        _, layer_rays = run_demos.layer_scene("cpu")
    return runs, layer_rays


def test_gallery_has_the_eleven_jax_demos():
    assert list(run_demos.DEMOS) == [
        "raytracer", "renderer", "lighting", "pbr", "normal_map",
        "panorama", "layer", "probe", "gi_comparison", "rt_graphics",
        "example"]
    assert (run_demos.W, run_demos.H) == (320, 240)
    assert (run_demos.GI_W, run_demos.GI_H, run_demos.GI_SPP) == (192, 144,
                                                                  4)


def read_ppm(path):
    with open(path, "rb") as f:
        data = f.read()
    magic, w, h, maxval, body = data.split(maxsplit=4)
    assert magic == b"P6" and maxval == b"255"
    return np.frombuffer(body, np.uint8).reshape(int(h), int(w), 3)


@pytest.mark.parametrize("name", list(IMAGES))
def test_demo_writes_its_images_and_hud(name, gallery):
    res, paths, text = gallery[0][name]
    assert sorted(res.images) == sorted(IMAGES[name])
    assert len(paths) == len(IMAGES[name])
    for path, (stem, img) in zip(paths, res.images.items()):
        assert path.endswith(f"{stem}.ppm")
        assert img.dtype == np.uint8 and img.shape == IMAGES[name][stem] + (3,)
        np.testing.assert_array_equal(read_ppm(path), img)
        assert img.any(), f"{stem}: the image is black"
    for key in HUD_KEYS.get(name, ()):
        assert key in text, (name, key, text)
    assert text == "".join(line + "\n" for line in res.lines)


def _jax_brute(tris, o, d, t_max=None, query_mask=-1):
    from messyerraytracer_tpu.core.brute import cast_rays_brute
    from messyerraytracer_tpu.core.types import make_rays, make_triangles

    jt = make_triangles(tris[:, 0], tris[:, 1], tris[:, 2])
    hits, _ = cast_rays_brute(make_rays(o, d, t_max=t_max), jt,
                              query_mask=query_mask)
    return hits


def _jax_room_with_sphere():
    from messyerraytracer_tpu.utils import meshes

    return np.concatenate([meshes.cornell_room(4.0),
                           meshes.uv_sphere(0.8, 16, 32, center=(0, -1.2,
                                                                 0))])


def test_example_cast_matches_jax_brute(gallery):
    from messyerraytracer_tpu.utils import meshes

    hud = gallery[0]["example"][0].hud
    o = np.float32([run_demos.EXAMPLE_ORIGIN])
    d = np.float32([run_demos.EXAMPLE_DIRECTION])
    h = _jax_brute(meshes.uv_sphere(1.0, 12, 24), o, d)
    assert hud["hit"] and bool(np_of(h.hit)[0])
    assert hud["prim_id"] == int(np_of(h.prim_id)[0])
    np.testing.assert_allclose(hud["distance"], float(np_of(h.t)[0]),
                               rtol=1e-5)


def test_probe_casts_match_jax_brute(gallery):
    probes = gallery[0]["probe"][0].hud["probes"]
    assert [p["z"] for p in probes] == list(run_demos.PROBE_ZS)
    tris = _jax_room_with_sphere()
    for p in probes:
        m = run_demos.probe_transform(p["z"])
        d = m[:3, :3] @ np.float32([0, 0, -1])
        d = d / max(np.linalg.norm(d), 1e-12)
        h = _jax_brute(tris, m[None, :3, 3], d[None].astype(np.float32),
                       t_max=np.float32([1000.0]))
        assert p["hit"] == bool(np_of(h.hit)[0])
        assert p["prim_id"] == int(np_of(h.prim_id)[0])
        np.testing.assert_allclose(p["distance"], float(np_of(h.t)[0]),
                                   rtol=1e-5)


def test_layer_hit_counts_match_jax_brute(gallery):
    from messyerraytracer_tpu.utils import meshes

    hud = gallery[0]["layer"][0].hud
    rays = gallery[1]
    s1 = meshes.uv_sphere(0.9, 12, 24, center=(-1.2, 0, 0))
    s2 = meshes.uv_sphere(0.9, 12, 24, center=(1.2, 0, 0))
    tris = np.concatenate([s1, s2])
    layers = np.concatenate([np.full(len(s1), 0b01, np.int32),
                             np.full(len(s2), 0b10, np.int32)])
    from messyerraytracer_tpu.core.brute import cast_rays_brute
    from messyerraytracer_tpu.core.types import make_rays, make_triangles

    jt = make_triangles(tris[:, 0], tris[:, 1], tris[:, 2], layers=layers)
    jr = make_rays(np_of(rays.origin), np_of(rays.direction),
                   np_of(rays.t_min), np_of(rays.t_max))
    counts = [int(np_of(cast_rays_brute(jr, jt, query_mask=m)[0].hit).sum())
              for m in (0b01, 0b10)]
    assert counts[0] > 0 and counts[1] > 0
    assert [hud["layer1_hits"], hud["layer2_hits"]] == counts


def test_main_prints_each_demo_and_writes_to_out(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(run_demos, "OUT", str(tmp_path))
    for k, v in SIZES.items():
        monkeypatch.setattr(run_demos, k, v)
    assert run_demos.main(["--device", "cpu", "layer", "example"]) == 0
    text = capsys.readouterr().out
    assert text.index("[layer]") < text.index("[example]")
    assert text.count("  done in ") == 2
    assert (tmp_path / "layer.ppm").exists()


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        run_demos.main(["example"])


def test_unknown_demo_is_refused():
    with pytest.raises(SystemExit):
        run_demos.main(["--device", "cpu", "nonesuch"])
