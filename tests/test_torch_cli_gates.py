"""The port's gate and real-asset CLIs (muscle_tpu_torch/cli/gates.py,
cli/real_run.py): every flag of the JAX package's CLIs parses in the port
(--platform swapped for --device), an oracle gate without the reference
tree exits non-zero with one line, and real_run's seg and eval stages on
a small synthetic tree with a random b1 dec checkpoint on the CPU."""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import muscle_tpu.cli.gates as j_gates
import muscle_tpu.cli.infer_mcl as j_infer_mcl
import muscle_tpu.cli.real_run as j_real_run
from muscle_tpu_torch.cli import gates, infer_mcl, real_run

REPO = Path(__file__).resolve().parents[1]


class _Parsed(Exception):
    pass


def _parser(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``main`` builds, caught at its parse_args."""
    box = {}

    def grab(self, args=None, namespace=None):
        box["p"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main([])
    return box["p"]


def _flags(p: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: a for a in p._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def _argv(actions) -> list[str]:
    """Every flag with a value of its type: its default, else its first
    choice, else 1 or a path-like string."""
    argv = []
    for opt, a in actions.items():
        if a.nargs == 0:
            argv.append(opt)
        elif a.choices:
            argv += [opt, str(a.choices[0])]
        elif a.default is not None:
            argv += [opt, str(a.default)]
        else:
            argv += [opt, "1" if a.type in (int, float) else "x"]
    return argv


@pytest.mark.parametrize("cli", ["gates", "real_run", "infer_mcl"])
def test_every_jax_flag_parses_in_the_port(cli, monkeypatch):
    jax_main, port_main, extra = {
        "gates": (j_gates.main, gates.main, {"--device", "--reference_root"}),
        "real_run": (j_real_run.main, real_run.main, {"--device", "--reference_root"}),
        "infer_mcl": (j_infer_mcl.main, infer_mcl.main, {"--device", "--fuse_mbconv"}),
    }[cli]
    want = _flags(_parser(jax_main, monkeypatch))
    port = _parser(port_main, monkeypatch)
    got = _flags(port)
    swapped = {"--platform"} if cli != "infer_mcl" else set()
    assert swapped <= set(want)
    assert set(got) == set(want) - swapped | extra
    for opt, a in want.items():
        if opt in swapped:
            continue
        assert got[opt].dest == a.dest and got[opt].type == a.type, opt
        if cli == "gates" and opt == "--quick_budget":
            # the JAX CLI's headroom over a time the port's tier took on its card
            assert got[opt].default == gates.QUICK_BUDGET_S <= 1.3 * gates.QUICK_MEASURED_S
        else:
            assert got[opt].default == a.default, opt
        assert got[opt].choices == a.choices, opt
    args = port.parse_args(_argv({k: v for k, v in want.items() if k not in swapped}))
    assert args.device == "cuda"  # the port's CLIs run on the card unless asked


def test_oracle_gate_without_reference_exits_with_one_line(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-m", "muscle_tpu_torch.cli.gates", "--gates", "1",
                          "--synthetic", "--out_dir", str(tmp_path / "g"), "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=str(tmp_path),
                         timeout=300)
    assert res.returncode != 0
    lines = res.stderr.strip().splitlines()
    assert len(lines) == 1 and "reference tree" in lines[0] and "--reference_root" in lines[0]
    assert res.stdout == "" and not (tmp_path / "g").exists()
    # a path that holds no reference tree is named the same way
    with pytest.raises(SystemExit, match="reference tree.*nowhere"):
        gates.main(["--gates", "4,7e", "--reference_root", str(tmp_path / "nowhere"),
                    "--device", "cpu"])


def test_real_run_seg_and_eval_on_a_synthetic_tree(tmp_path):
    from muscle_tpu_torch.data.transforms import color_norm
    from muscle_tpu_torch.gates import build_synthetic_voc
    from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights

    root = tmp_path / "voc"
    names = build_synthetic_voc(str(root), sizes=[(48, 64), (64, 48), (42, 64)])
    model = init_weights(MuSCLe(backbone_name="efficientnet-b1", mode="dec", bifpn_layers=1),
                         torch.Generator().manual_seed(0)).eval()
    cal = np.stack([color_norm(np.asarray(Image.open(root / "JPEGImages" / f"{n}.jpg"))
                               [:40, :40]) for n in names])
    with torch.inference_mode():
        calibrate_seg_head(model, torch.from_numpy(cal))
    ckpt = tmp_path / "seg.pth"
    torch.save(model.state_dict(), ckpt)
    out = tmp_path / "run"
    report = real_run.main(["--voc12_root", str(root), "--list", str(root / "list.txt"),
                            "--cls_labels", str(root / "cls_labels.npy"),
                            "--seg_weights", str(ckpt), "--out_dir", str(out),
                            "--stages", "seg,eval", "--seg_backbone", "b1", "--bifpn", "1",
                            "--batch_size", "2", "--device", "cpu"])
    pngs = sorted(p.stem for p in (out / "seg").glob("*.png"))
    assert pngs == sorted(names)
    for n in names:
        pred = np.asarray(Image.open(out / "seg" / f"{n}.png"))
        assert pred.shape == np.asarray(Image.open(root / "JPEGImages" / f"{n}.jpg")).shape[:2]
    on_disk = json.loads((out / "real_run_report.json").read_text())
    assert on_disk["stages"] == report["stages"]
    seg, ev = report["stages"]["seg"], report["stages"]["eval"]
    assert seg["pngs"] == len(names) and seg["crf_ms_per_image"] > 0
    assert seg["backbone_forwards"] == 2 * 6  # 2 batches x the six TTA scales
    assert 0.0 <= ev["mIoU"] <= 100.0 and np.isfinite(ev["mIoU"])
    log = (out / "real_run.log").read_text()
    assert "stage seg done: 3 PNGs" in log and "stage eval done" in log
    assert (out / "evallog.txt").exists()
