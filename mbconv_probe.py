#!/usr/bin/env python3
"""Time the MBConv kernel's launches by kernel name against a block's
channel widths, on one CUDA card: the sweeps behind PERF.md's findings on
what binds the bf16 instantiation.

    python3 mbconv_probe.py                 # both sweeps
    python3 mbconv_probe.py --sweep project # (c) against Cmid and Cout
    python3 mbconv_probe.py --sweep expand  # (a) against Cin at one Cmid
    python3 mbconv_probe.py --sweep host    # where a call's host time goes

project: blocks without an expand at 16 x 384 x 512 (b3 _blocks_0's
scale-2 grid), Cin = Cmid in 24 .. 128 and Cout 24 .. 64, bf16 and f32.
expand: blocks with an expand at Cmid 192 (k 3, 16 x 192 x 256, b3
_blocks_3's grid) and 288 (k 5, 16 x 96 x 128, _blocks_6's), Cin from
32 up.  Each case: one warm-up call, then the device ms of each launch
averaged over 3 calls (torch.profiler), one JSON line a case.  host: the
wrapper's host µs a call (the mean of HOST_CALLS calls with the device
idle) at b3 _blocks_13's scale-1 shape, bf16 and f32, and the functions
that take it (cProfile, by own time).  Needs the kernels built
(``chip_smoke.py --phases build`` or the first launch).
"""

from __future__ import annotations

import argparse
import json

# (Cin, Cout, expand ratio, k, (H, W)), B = 16
PROJECT_CASES = [(40, 24, 1, 3, (384, 512)), (64, 24, 1, 3, (384, 512)),
                 (64, 32, 1, 3, (384, 512)), (24, 24, 1, 3, (384, 512)),
                 (32, 32, 1, 3, (384, 512)), (40, 40, 1, 3, (384, 512)),
                 (48, 48, 1, 3, (384, 512)), (64, 64, 1, 3, (384, 512)),
                 (128, 24, 1, 3, (384, 512))]
EXPAND_CASES = [(32, 32, 6, 3, (192, 256)), (48, 48, 4, 3, (192, 256)),
                (64, 64, 3, 3, (192, 256)), (96, 96, 2, 3, (192, 256)),
                (128, 128, 2, 3, (192, 256)), (48, 48, 6, 5, (96, 128)),
                (72, 72, 4, 5, (96, 128)), (96, 96, 3, 5, (96, 128)),
                (144, 144, 2, 5, (96, 128))]
REPS = 3
HOST_CALLS = 300


def probe(cases, dtypes) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    from muscle_tpu_torch.ops import mbconv as M

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for cin, cout, expand, k, hw in cases:
        block = C._random_block(cin, cout, expand, k, gen, dev)
        kw = dict(k=k, has_expand=expand != 1, has_skip=cin == cout)
        for dt in dtypes:
            wd = block.fused_weights(dt)
            x = torch.randn((16, *hw, cin), device=dev).to(dt)
            with torch.inference_mode():
                M.mbconv_stride1(x, wd, None, **kw)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(REPS):
                        M.mbconv_stride1(x, wd, None, **kw)
                    torch.cuda.synchronize()
            rows = {name.split("::")[1].split("<")[0].split("(")[0]: ms / REPS
                    for ms, _, name in C._device_rows(prof) if "::" in name}
            print(json.dumps({"Cin": cin, "Cmid": cin * expand, "Cout": cout, "k": k,
                              "B": 16, "H": hw[0], "W": hw[1], "dtype": str(dt),
                              "device_ms": rows}), flush=True)
            del x


def host(top: int = 25) -> None:
    import cProfile
    import io
    import pstats
    import time

    import torch

    import chip_smoke as C
    from muscle_tpu_torch.ops import mbconv as M

    dev = torch.device("cuda")
    block = C._random_block(96, 136, 6, 5, torch.Generator().manual_seed(0), dev)
    win = C._windows(16, 1.0, dev)
    kw = dict(k=5, has_expand=True, has_skip=False)
    for dt in (torch.bfloat16, torch.float32):
        wd = block.fused_weights(dt)
        x = torch.randn((16, 24, 32, 96), device=dev).to(dt)
        with torch.inference_mode():
            M.mbconv_stride1(x, wd, win, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                M.mbconv_stride1(x, wd, win, **kw)
                torch.cuda.synchronize()
            per_call = (time.perf_counter() - t0) / HOST_CALLS * 1e6
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(HOST_CALLS):
                M.mbconv_stride1(x, wd, win, **kw)
                torch.cuda.synchronize()
            prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
        top_rows = []
        for ln in out.getvalue().splitlines():
            r = ln.split(None, 5)  # ncalls tottime percall cumtime percall where
            if len(r) == 6 and r[1].replace(".", "", 1).isdigit():
                top_rows.append([r[5][:90], float(r[1]) / HOST_CALLS * 1e6])
        print(json.dumps({"host": str(dt), "us_per_call_synchronised": per_call,
                          "top_own_us_per_call": top_rows}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sweep", choices=("project", "expand", "host", "both"), default="both")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("mbconv_probe: no CUDA device")
        return 1
    if args.sweep in ("project", "both"):
        probe(PROJECT_CASES, (torch.bfloat16, torch.float32))
    if args.sweep in ("expand", "both"):
        probe(EXPAND_CASES, (torch.bfloat16,))
    if args.sweep == "host":
        host()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
