"""The port's resize functions and CamTTAEngine (muscle_tpu_torch) against
the JAX package's on the same weights and synthetic images (b1, small
canvases)."""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import muscle_tpu.core.resize as JR
from muscle_tpu.inference import CamTTAEngine as JEngine
from muscle_tpu.models import MuSCLe as JMuSCLe
import muscle_tpu_torch.core.resize as TR
from muscle_tpu_torch.convert import state_dict_from_jax
from muscle_tpu_torch.inference import CamTTAEngine
from muscle_tpu_torch.models import MuSCLe

# resize weights and maps: f32 on both sides, a few products deep
RESIZE_ATOL = 1e-5
# the JAX package's engine bounds (test_inference.py): scores through a
# sigmoid of f32 logits; SGC maps after the min-max normalisation, which
# amplifies float noise, and a float16 (or uint8) download
SCORE_ATOL, SGC_ATOL = 1e-4, 5e-3


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("ac", [True, False])
def test_resize_bilinear_matches_jax(ac):
    x = np.random.default_rng(0).normal(size=(2, 9, 13, 3)).astype(np.float32)
    for hw in [(17, 5), (9, 13), (4, 26)]:
        want = JR.resize_bilinear(jnp.asarray(x), hw, align_corners=ac)
        got = TR.resize_bilinear(_t(x), hw, align_corners=ac)
        np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)
    # HWC and HW inputs
    np.testing.assert_allclose(TR.resize_bilinear(_t(x[0]), (5, 7), ac).numpy(),
                               JR.resize_bilinear(jnp.asarray(x[0]), (5, 7), ac),
                               atol=RESIZE_ATOL)
    np.testing.assert_allclose(TR.resize_bilinear(_t(x[0, ..., 0]), (5, 7), ac).numpy(),
                               JR.resize_bilinear(jnp.asarray(x[0, ..., 0]), (5, 7), ac),
                               atol=RESIZE_ATOL)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("ac", [True, False])
def test_dynamic_window_resize_matches_jax(ac, flip):
    rng = np.random.default_rng(1)
    fm = rng.normal(size=(3, 12, 16, 4)).astype(np.float32)
    box = np.array([[0, 0, 12, 16], [1, 2, 7, 9], [0, 3, 5, 13]], np.int32)
    dst = np.array([[30, 40], [17, 11], [32, 32]], np.int32)
    want = jax.vmap(lambda m, b, d: JR.dynamic_window_resize(
        m, b, (32, 40), dst_hw=d, align_corners=ac, flip_x=flip))(
        jnp.asarray(fm), jnp.asarray(box), jnp.asarray(dst))
    got = TR.dynamic_window_resize(_t(fm), _t(box), (32, 40), dst_hw=_t(dst),
                                   align_corners=ac, flip_x=flip)
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)
    one = TR.dynamic_window_resize(_t(fm[1]), _t(box[1]), (32, 40), dst_hw=_t(dst[1]),
                                   align_corners=ac, flip_x=flip)
    np.testing.assert_allclose(one.numpy(), want[1], atol=RESIZE_ATOL)


def test_resize_weight_builders_match_jax():
    src = np.array([500, 375, 37, 64], np.int32)
    dst = np.array([250, 750, 64, 37], np.int32)
    off = np.array([0, 3, 1, 0], np.int32)
    for flip in (False, True):
        want = jax.vmap(lambda s, d, o: JR.dynamic_cubic_resize_weights(
            s, d, 512, 768, flip=flip, dst_off=o))(jnp.asarray(src), jnp.asarray(dst),
                                                    jnp.asarray(off))
        got = TR.dynamic_cubic_resize_weights(_t(src), _t(dst), 512, 768, flip=flip,
                                              dst_off=_t(off))
        np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)
        for ac in (True, False):
            want = jax.vmap(lambda s, d, o: JR.dynamic_bilinear_resize_weights(
                s, d, 512, 768, align_corners=ac, flip=flip, src_off=o, dst_off=o))(
                jnp.asarray(src), jnp.asarray(dst), jnp.asarray(off))
            got = TR.dynamic_bilinear_resize_weights(
                _t(src), _t(dst), 512, 768, align_corners=ac, flip=flip, src_off=_t(off),
                dst_off=_t(off))
            np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)
        m, mid = np.array([31, 23, 2, 4], np.int32), src
        want = jax.vmap(lambda a, b, c: JR.composed_cam_resize_weights(
            a, b, c, 32, 512, 768, flip=flip))(jnp.asarray(m), jnp.asarray(mid),
                                                jnp.asarray(dst))
        got = TR.composed_cam_resize_weights(_t(m), _t(mid), _t(dst), 32, 512, 768,
                                             flip=flip)
        np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)


def test_batched_window_resize_ac_matches_jax():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(2, 16, 24, 5)).astype(np.float32)
    sw = np.array([[0, 0, 12, 20], [0, 0, 16, 9]], np.int32)
    dw = np.array([[0, 0, 3, 5], [0, 0, 4, 2]], np.int32)
    want = JR.batched_window_resize_ac(jnp.asarray(src), jnp.asarray(sw), jnp.asarray(dw),
                                       (4, 6))
    got = TR.batched_window_resize_ac(_t(src), _t(sw), _t(dw), (4, 6))
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)


# ---- the engine ------------------------------------------------------------

SIZES = [(50, 40), (40, 56), (50, 40)]  # two landscape-free shapes, one repeated


def _images(seed):
    """Smooth colour ramps plus noise: structure for the random network to
    respond to, so the CAMs vary over the image."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SIZES:
        mix = rng.uniform(-1.0, 1.0, size=(2, 3))
        yy = np.linspace(0, 1, h)[:, None, None]
        xx = np.linspace(0, 1, w)[None, :, None]
        base = 127.5 + 100 * (yy * mix[0] + xx * mix[1]) + rng.normal(0, 8, size=(h, w, 3))
        out.append(Image.fromarray(np.clip(base, 0, 255).astype(np.uint8)))
    return out


def _labels():
    labels = [np.zeros(20, np.float32) for _ in SIZES]
    labels[0][[2, 7]] = 1
    labels[1][[0]] = 1
    labels[2][[4, 11, 19]] = 1
    return labels


def _randomize_bn(tree, stats, rng):
    """Batch norms near the identity with random scale, shift and
    statistics, so a random b1's maps stay O(1) (identity norms shrink
    them to ~1e-7, where the min-max fusion degenerates)."""
    for k, sub in tree.items():
        if "scale" in sub:
            n = sub["scale"].shape
            sub["scale"] = rng.uniform(0.75, 1.25, n).astype(np.float32)
            sub["bias"] = rng.uniform(-0.1, 0.1, n).astype(np.float32)
            stats[k]["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats[k]["var"] = rng.uniform(0.5, 1.0, n).astype(np.float32)
        elif "kernel" not in sub:
            _randomize_bn(sub, stats.setdefault(k, {}), rng)


def _plain(tree):
    return {k: _plain(v) if hasattr(v, "items") else np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    jm = JMuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    v = _plain(jm.init({"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)), mode="cam"))
    _randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(0))
    sd = state_dict_from_jax(v)

    def port(fuse):
        m = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False,
                   fuse_mbconv=fuse)
        m.load_state_dict(sd, strict=False)
        return m

    return jm, v, port


ENGINE_CASES = {
    # name: (run, engine kwargs)
    "exact": ("exact", dict(scales=(0.5, 1.0))),
    "host_prep": ("batch", dict(scales=(0.5, 1.0), device_tta=False)),
    "device_fast0": ("batch", dict(scales=(0.5, 1.0))),
    "device_fast1": ("batch", dict(scales=(1.0,), accum_stride=4, download_dtype="uint8",
                                   tight_upload=True, upload_mode="ycbcr420",
                                   return_cam=False)),
    "device_fullres": ("batch", dict(scales=(1.0,), lowres=False)),
}


def _assert_fused_close(got, want, what):
    """Fused maps agree to SGC_ATOL away from the reference's
    pre-normalisation zeroing (fg < min + 1e-6).  That zeroing is a
    discontinuity: a pixel within 1e-6 of the map's minimum goes to the
    map's lowest output -(min + 1e-6) / (range + 1e-6) on one side and to
    ~0 on the other when float noise differs.  The zeroed pixels share the
    lowest value, so they are found exactly; the two sides may disagree on
    at most 1% of them, and the zeroed value itself is compared relatively
    (it divides by the map's range)."""
    zg, zw = got == got.min(), want == want.min()
    flips = zg != zw
    assert flips.mean() <= 0.01, (what, int(flips.sum()))
    keep = ~(zg | zw)
    np.testing.assert_allclose(got[keep], want[keep], atol=SGC_ATOL, err_msg=what)
    np.testing.assert_allclose(got.min(), want.min(), rtol=1e-2, atol=SGC_ATOL, err_msg=what)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_cam_engine_matches_jax(models, case):
    jm, v, port = models
    run, kw = ENGINE_CASES[case]
    kw = dict(out_side=64, max_side=60, **kw)
    imgs, labels, names = _images(3), _labels(), ["a", "b", "c"]
    jeng = JEngine(jm, v, **kw)
    teng = CamTTAEngine(port(384), device="cpu", **kw)
    if run == "exact":
        want = jeng.run_batch_exact(imgs, names, labels)
        got = teng.run_batch_exact(imgs, names, labels)
    else:
        want = jeng.run_batch(imgs, names, labels)
        # the port also takes HWC uint8 arrays
        got = teng.run_batch([np.asarray(i) for i in imgs], names, labels)
    assert len(got) == len(want)
    for g, w, (h, wd) in zip(got, want, SIZES):
        assert g["name"] == w["name"]
        np.testing.assert_allclose(g["score"], w["score"], atol=SCORE_ATOL)
        for key in ("sgc", "cam"):
            if key not in w:
                assert key not in g
                continue
            assert sorted(g[key]) == sorted(w[key])
            for c in w[key]:
                a, b = np.asarray(g[key][c], np.float32), np.asarray(w[key][c], np.float32)
                assert g[key][c].dtype == w[key][c].dtype and a.shape == (h, wd)
                _assert_fused_close(a, b, f"{case} {key} {c}")


def test_cam_engine_maps_are_not_degenerate(models):
    """The comparison above means something: most fused maps spread over
    [0, 1] rather than collapsing to one value (a class whose random
    classifier row is negative everywhere gives a constant map)."""
    _, _, port = models
    teng = CamTTAEngine(port(0), scales=(1.0,), out_side=64, max_side=60, device="cpu")
    out = teng.run_batch(_images(3), ["a", "b", "c"], _labels())
    spreads = [float(m.max()) - float(m.min()) for rec in out for m in rec["sgc"].values()]
    assert sum(s > 0.5 for s in spreads) >= len(spreads) / 2, spreads


def test_cam_run_stream_matches_run_batch(models):
    _, _, port = models
    engine = CamTTAEngine(port(384), scales=(0.5, 1.0), out_side=64, max_side=60,
                          max_classes=4, return_cam=False, accum_stride=4,
                          download_dtype="uint8", tight_upload=True, upload_mode="ycbcr420",
                          device="cpu")

    def batch(i):
        sizes = [(50, 40), (40, 56)]
        rng = np.random.default_rng(i)
        imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in sizes]
        labels = [np.zeros(20, np.float32) for _ in sizes]
        labels[0][[i % 20, (i + 3) % 20]] = 1
        labels[1][[(i + 1) % 20]] = 1
        return imgs, [f"s{i}_0", f"s{i}_1"], labels

    want = [engine.run_batch(*batch(i)) for i in range(3)]
    got = list(engine.run_stream(batch(i) for i in range(3)))
    later = engine.run_batch_async(*batch(0))
    assert len(got) == 3
    for wb, gb in zip(want + want[:1], got + [later()]):
        for w, g in zip(wb, gb):
            assert w["name"] == g["name"]
            np.testing.assert_array_equal(w["score"], g["score"])
            assert sorted(w["sgc"]) == sorted(g["sgc"])
            for k in w["sgc"]:
                np.testing.assert_array_equal(w["sgc"][k], g["sgc"][k])


def test_cam_run_stream_propagates_producer_error(models):
    _, _, port = models
    engine = CamTTAEngine(port(0), scales=(0.5,), out_side=64, max_side=60, device="cpu")

    def batches():
        yield [np.zeros((40, 40, 3), np.uint8)], ["ok"], [np.ones(20, np.float32)]
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(engine.run_stream(batches()))


def test_cam_engine_rejects_unsupported_options(models):
    _, _, port = models
    with pytest.raises(NotImplementedError, match="float32"):
        CamTTAEngine(port(0), compute_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError):
        CamTTAEngine(port(0), download_dtype="float32", device="cpu")
    with pytest.raises(ValueError):
        CamTTAEngine(port(0), upload_mode="yuv", device="cpu")
