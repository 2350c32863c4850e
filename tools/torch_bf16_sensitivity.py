"""How far bf16 moves a random MuSCLe-b7 dec's seg labels, in the JAX package
and in the PyTorch port, on the CPU.

Both models carry the same seeded random weights (the port's
``init_weights``, the head calibrated so labels vary, converted to the JAX
tree) and see the same two images (colour ramps, 128 x 112 and 96 x 128 on a
128 x 128 canvas, window-exact).  On the pixels whose f32 top-two
probability margin exceeds 1e-2 it prints, per image, how often the labels
(argmax of the 'seg' logits) agree: JAX bf16 vs JAX f32, port bf16 vs JAX
bf16, port bf16 vs port f32 and port f32 vs JAX f32.  The reference's silu
and sigmoid are taken in f32 and rounded once, as in
tests/test_torch_bf16_mbconv.py.  A few minutes of CPU (two b7 compiles):

    JAX_PLATFORMS=cpu python tools/torch_bf16_sensitivity.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import flax.linen  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from muscle_tpu.convert import convert_muscle_state_dict  # noqa: E402
from muscle_tpu.models import MuSCLe as JMuSCLe  # noqa: E402
from muscle_tpu_torch.models import MuSCLe, calibrate_seg_head, init_weights  # noqa: E402
from test_torch_bf16_models import _canvas, _ramps  # noqa: E402

SIZES = [(128, 112), (96, 128)]
MARGIN = 1e-2


def main() -> None:
    def once(fn):
        return lambda x: fn(x.astype(jnp.float32)).astype(x.dtype)

    flax.linen.silu = once(flax.linen.silu)
    jax.nn.sigmoid = once(jax.nn.sigmoid)
    model = MuSCLe(backbone_name="efficientnet-b7", mode="dec", bifpn_layers=3,
                   bifpn_channels=256)
    init_weights(model, torch.Generator().manual_seed(0)).eval()
    with torch.inference_mode():
        calibrate_seg_head(model, torch.from_numpy(_ramps(2, (128, 128), seed=0)))
    sd = {k: t.numpy() for k, t in model.state_dict().items() if "num_batches_tracked" not in k}
    variables = convert_muscle_state_dict(sd)
    x, win = _canvas(SIZES, side=128)

    def jax_logits(dtype):
        jm = JMuSCLe(backbone_name="efficientnet-b7", mode="dec", bifpn_layers=3, dtype=dtype)
        run = jax.jit(lambda v, x, w: jm.apply(v, x, mode="seg", valid_window=w)[0])
        return np.asarray(run(variables, jnp.asarray(x, dtype), jnp.asarray(win))
                          .astype(jnp.float32))

    def port_logits(dtype):
        with torch.inference_mode():
            out = model(torch.from_numpy(np.array(x)).to(dtype), mode="seg",
                        valid_window=torch.from_numpy(win))[0]
        return out.float().numpy()

    j16, j32 = jax_logits(jnp.bfloat16), jax_logits(jnp.float32)
    p16, p32 = port_logits(torch.bfloat16), port_logits(torch.float32)
    prob = np.exp(j32 - j32.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    top2 = np.sort(prob, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    for i, (h, w) in enumerate(SIZES):
        c = clear[i, :h, :w]

        def agree(a, b):
            return float((a[i, :h, :w].argmax(-1) == b[i, :h, :w].argmax(-1))[c].mean())

        print(f"image {i}: clear share {c.mean():.4f}; labels agree on the clear pixels: "
              f"jax bf16 vs jax f32 {agree(j16, j32):.4f}, port bf16 vs jax bf16 "
              f"{agree(p16, j16):.4f}, port bf16 vs port f32 {agree(p16, p32):.4f}, "
              f"port f32 vs jax f32 {agree(p32, j32):.4f}")


if __name__ == "__main__":
    main()
