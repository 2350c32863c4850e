"""The port's training data path (muscle_tpu_torch/data, core/ycbcr,
training/mcl decode) against the JAX package's on a synthetic miniature
VOC tree: each transform draw for draw from one seed, the MCL dataset in
its three upload modes and the prefetch loader's batches bit-equal, the
4:2:0 device decode within 1e-4 (f32)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from muscle_tpu.core.ycbcr import ycbcr420_to_rgb as j_ycbcr420_to_rgb
from muscle_tpu.data import PrefetchLoader as JPrefetchLoader
from muscle_tpu.data import VOC12ClsPixDataset as JClsPix
from muscle_tpu.data import transforms as JT
from muscle_tpu.data import voc12 as jvoc
from muscle_tpu.training.mcl import decode_image as j_decode_image
from muscle_tpu_torch.core.ycbcr import rgb_to_ycbcr420, ycbcr420_to_rgb
from muscle_tpu_torch.data import transforms as T
from muscle_tpu_torch.data import voc12 as tvoc
from muscle_tpu_torch.data.loader import PrefetchLoader
from muscle_tpu_torch.data.voc12 import VOC12ClsPixDataset
from muscle_tpu_torch.training import decode_image

CATS = ["aeroplane", "cat", "dog", "person"]


@pytest.fixture(scope="module")
def mini_voc(tmp_path_factory):
    """JPEGImages + Annotations + list; cls_labels.npy built from the XML
    by the port (and held to the JAX package's)."""
    root = tmp_path_factory.mktemp("voc")
    for d in ("JPEGImages", "Annotations"):
        os.makedirs(root / d)
    rng = np.random.default_rng(0)
    names = [f"2007_{i:06d}" for i in range(6)]
    for i, n in enumerate(names):
        h, w = (60 + 4 * i, 80 - 4 * i) if i % 3 else (500, 375)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{n}.jpg")
        objs = "".join(f"<object><name>{c}</name></object>"
                       for c in (CATS[i % 4], CATS[(i + 1) % 4])[: 1 + i % 2])
        (root / "Annotations" / f"{n}.xml").write_text(f"<annotation>{objs}</annotation>")
    (root / "list.txt").write_text("\n".join(names) + "\n")
    tvoc.build_cls_labels(names, str(root), str(root / "cls_labels.npy"))
    return root, names


def _same(a, b):
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, Image.Image):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _img(seed, hw=(70, 90)):
    return Image.fromarray(
        np.random.default_rng(seed).integers(0, 255, (*hw, 3), dtype=np.uint8))


TRANSFORMS = {
    "random_resize_long": lambda M, r: M.random_resize_long(_img(1), 60, 120, r),
    "random_crop_pad": lambda M, r: M.random_crop(
        np.asarray(_img(2), np.float32), 96, r),
    "random_crop_u8_fill_extra": lambda M, r: M.random_crop(
        np.asarray(_img(3)), 48, r, extra=np.ones((70, 90, 1), np.float32),
        fill=M.IMAGENET_MEAN_U8),
    "color_jitter": lambda M, r: M.color_jitter(_img(4), r),
    "random_erasing": lambda M, r: M.random_erasing(np.asarray(_img(5)), r, p=1.0),
    "random_erasing_skip": lambda M, r: M.random_erasing(np.asarray(_img(5)), r, p=0.0),
    "hflip": lambda M, r: M.hflip(np.asarray(_img(6))),
    "two_views": lambda M, r: M.two_views(_img(7, (500, 375)), r, (224, 224)),
    "two_views_small": lambda M, r: M.two_views(_img(8), r, (32, 32)),
    "cutout": lambda M, r: M.cutout(np.asarray(_img(9)), np.ones((70, 90), np.uint8), r, p=1.0),
    "denorm_to_uint8": lambda M, r: M.denorm_to_uint8(M.color_norm(np.asarray(_img(10)))),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax_draw_for_draw(name):
    """Same output from one seed, and the same draws consumed (the next
    draw of both generators agrees)."""
    for seed in range(3):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        _same(TRANSFORMS[name](T, ra), TRANSFORMS[name](JT, rb))
        assert ra.random() == rb.random()


def test_intersection_and_constants_match_jax():
    for c1, c2 in (((0, 0, 10, 10), (5, 5, 10, 10)), ((0, 0, 4, 4), (4, 4, 4, 4)),
                   ((3, 1, 8, 9), (0, 2, 20, 3))):
        assert T._intersection(c1, c2) == JT._intersection(c1, c2)
    np.testing.assert_array_equal(T.IMAGENET_MEAN_U8, JT.IMAGENET_MEAN_U8)
    assert tvoc.VOC_CAT_LIST == jvoc.VOC_CAT_LIST
    assert tvoc.VOC_CLASS_COUNTS == jvoc.VOC_CLASS_COUNTS


def test_labels_from_xml_match_jax(mini_voc):
    root, names = mini_voc
    d = np.load(root / "cls_labels.npy", allow_pickle=True).item()
    for n in names:
        np.testing.assert_array_equal(d[n], jvoc.load_label_from_xml(n, str(root)))
    labels = [d[n] for n in names]
    np.testing.assert_array_equal(tvoc.class_frequency_sample_weights(labels),
                                  jvoc.class_frequency_sample_weights(labels))


UPLOADS = {"f32": dict(device_norm=False), "u8_rgb": dict(device_norm=True, upload="rgb"),
           "ycbcr420": dict(device_norm=True, upload="ycbcr420")}


@pytest.mark.parametrize("mode", sorted(UPLOADS))
def test_cls_pix_dataset_matches_jax(mini_voc, mode):
    root, names = mini_voc
    labels = tvoc.load_label_dict(str(root / "cls_labels.npy"))
    kw = dict(crop_size=64, view_size=(32, 32), **UPLOADS[mode])
    ours = VOC12ClsPixDataset(names, str(root), labels, **kw)
    ref = JClsPix(names, str(root), labels, **kw)
    for idx in range(len(names)):
        a = ours.get(idx, np.random.default_rng(idx))
        b = ref.get(idx, np.random.default_rng(idx))
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cls_pix_dataset_rejects_bad_uploads(mini_voc):
    root, names = mini_voc
    with pytest.raises(ValueError, match="requires device_norm"):
        VOC12ClsPixDataset(names, str(root), {}, upload="ycbcr420")
    with pytest.raises(ValueError, match="even"):
        VOC12ClsPixDataset(names, str(root), {}, crop_size=63, device_norm=True,
                           upload="ycbcr420")


@pytest.mark.parametrize("weighted", [False, True])
def test_prefetch_loader_batches_bit_equal(mini_voc, weighted):
    """Two epochs of shuffled (or weight-sampled) batches, seed 3, the
    4:2:0 upload: every array equal to the JAX package's loader's."""
    root, names = mini_voc
    labels = tvoc.load_label_dict(str(root / "cls_labels.npy"))
    kw = dict(crop_size=64, view_size=(32, 32), device_norm=True, upload="ycbcr420")
    w = tvoc.class_frequency_sample_weights([labels[n] for n in names]) if weighted else None
    ours = PrefetchLoader(VOC12ClsPixDataset(names, str(root), labels, **kw), 2, seed=3,
                          num_threads=3, sample_weights=w)
    ref = JPrefetchLoader(JClsPix(names, str(root), labels, **kw), 2, seed=3, num_threads=2,
                          sample_weights=w)
    for ep in (0, 1):
        got, want = list(ours.epoch(ep)), list(ref.epoch(ep))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetch_loader_raises_a_worker_error():
    class Broken:
        def __len__(self):
            return 4

        def get(self, idx, rng):
            raise OSError(f"cannot read sample {idx}")

    with pytest.raises(OSError, match="cannot read sample"):
        list(PrefetchLoader(Broken(), 2, num_threads=1).epoch(0))


def test_ycbcr420_pack_and_decode_match_jax():
    """The host pack equal, the device decode within 1e-4, and the decode
    (through ``decode_image``, normalised) in every upload format."""
    from muscle_tpu.core.ycbcr import rgb_to_ycbcr420 as j_rgb_to_ycbcr420

    rgb = np.asarray(_img(11, (32, 48)))
    y, c = rgb_to_ycbcr420(rgb)
    jy, jc = j_rgb_to_ycbcr420(rgb)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(c, jc)
    got = ycbcr420_to_rgb(torch.from_numpy(y[None]), torch.from_numpy(c[None])).numpy()
    want = np.asarray(j_ycbcr420_to_rgb(jnp.asarray(y[None]), jnp.asarray(c[None])))
    np.testing.assert_allclose(got, want, atol=1e-4)
    batch = {"img_y": y[None], "img_c": c[None], "v": rgb[None],
             "f": T.color_norm(rgb)[None]}
    for key in ("img", "v", "f"):
        got = decode_image({k: torch.from_numpy(a) for k, a in batch.items()}, key).numpy()
        want = np.asarray(j_decode_image({k: jnp.asarray(a) for k, a in batch.items()}, key))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)
    with pytest.raises(ValueError, match="even sides"):
        rgb_to_ycbcr420(rgb[:31])
