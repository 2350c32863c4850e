"""``infer_mcl`` / ``infer_seg --spatial 2`` under torchrun on 4 CPU ranks
over gloo: a 2 x 2 mesh, every rank handing the engine the global batch
and the engine splitting it over the data axis (each data row's share on
its 2 stripes), each image's files written once; held to one process by
test_torch_spatial.py's CLI bounds (the JAX CLI test's 5e-3 for the
``--fast 1`` SGC maps, seg labels on 99.9% of the pixels).  The weights
are test_torch_mesh_engines.py's, the mini-VOC test_torch_spatial.py's."""

import numpy as np
from PIL import Image

from muscle_tpu_torch.cli import infer_mcl, infer_seg
from test_torch_mesh_engines import spec  # noqa: F401  (fixture, for mini_voc)
from test_torch_spatial import (
    CLI_LABEL_AGREE,
    CLI_SGC_ATOL,
    _fused_close,
    _torchrun,
    mini_voc,  # noqa: F401  (fixture)
)


def test_infer_mcl_spatial_2_on_4_ranks_writes_the_one_process_files(mini_voc, tmp_path):
    """``infer_mcl --spatial 2`` (--fast 1) on 4 ranks, a 2 x 2 mesh: every
    rank hands the engine the batch of 4, each data row runs 2 images on 2
    stripes, and each image's SGC dict is written once; one process's
    within the JAX CLI test's 5e-3."""
    root, names = mini_voc
    args = ["--weights", str(root / "cam.pth"), "--infer_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--backbone", "efficientnet-b1", "--scales", "0.5,1", "--batch_size", "4",
            "--device", "cpu", "--num_workers", "1"]
    infer_mcl.main(args + ["--out_npy", str(tmp_path / "one")])
    stdout = _torchrun("muscle_tpu_torch.cli.infer_mcl",
                       args + ["--out_npy", str(tmp_path / "four"), "--spatial", "2"], tmp_path,
                       nproc=4)
    assert stdout.count('"mesh": {"data": 2, "model": 2}') == 4
    assert stdout.count('"images": 4') == 4  # every rank returned the whole batch
    for n in names:
        a = np.load(tmp_path / "one_sgc" / f"{n}.npy", allow_pickle=True).item()
        b = np.load(tmp_path / "four_sgc" / f"{n}.npy", allow_pickle=True).item()
        assert sorted(a) == sorted(b)
        for c in a:
            _fused_close(b[c].astype(np.float32), a[c].astype(np.float32), CLI_SGC_ATOL, n)


def test_infer_seg_spatial_2_on_4_ranks_writes_the_one_process_pngs(mini_voc, tmp_path):
    """``infer_seg --spatial 2 --crf 0`` on 4 ranks (a 2 x 2 mesh, batches
    of 2): one PNG an image, equal to one process's on 99.9% of its
    pixels."""
    root, names = mini_voc
    args = ["--weights", str(root / "seg.pth"), "--infer_list", str(root / "list.txt"),
            "--voc12_root", str(root), "--cls_labels", str(root / "cls_labels.npy"),
            "--pretrained", "b1", "--bifpn", "1", "--crf", "0", "--batch_size", "2",
            "--device", "cpu", "--num_workers", "1"]
    infer_seg.main(args + ["--out_seg", str(tmp_path / "one")])
    _torchrun("muscle_tpu_torch.cli.infer_seg",
              args + ["--out_seg", str(tmp_path / "four"), "--spatial", "2"], tmp_path, nproc=4)
    assert sorted(p.stem for p in (tmp_path / "four").iterdir()) == sorted(names)
    for n in names:
        a = np.asarray(Image.open(tmp_path / "one" / f"{n}.png"))
        b = np.asarray(Image.open(tmp_path / "four" / f"{n}.png"))
        assert a.shape == b.shape
        assert (a == b).mean() >= CLI_LABEL_AGREE, n
