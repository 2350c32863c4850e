"""The JAX package's ``model_<epoch>.msgpack`` (Flax's ``to_bytes`` of
``{params, batch_stats}``) read by the port's own decoder
(``convert.read_flax_msgpack``, no ``msgpack`` package): bytes written here
by ``flax.serialization.to_bytes`` from a MuSCLe-b1 init at bf16 (its
classifier kernel bfloat16) and at f32 load bit for bit, each leaf in its
dtype, into the tree and through ``cli.common.load_model_state`` into the
model."""

import os
import subprocess
import sys

import flax.serialization
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from muscle_tpu.models import MuSCLe as JMuSCLe
from muscle_tpu_torch.cli.common import load_model_state
from muscle_tpu_torch.convert import read_flax_msgpack, state_dict_from_jax
from muscle_tpu_torch.models import MuSCLe


def _bits(a) -> np.ndarray:
    """A leaf's raw bits (bfloat16 as uint16), whichever side made it."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flax_msgpack_loads_bit_for_bit(dtype, tmp_path):
    jm = JMuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False,
                 dtype=getattr(jnp, dtype))
    v = jax.tree.map(np.asarray, jm.init({"params": jax.random.key(3)},
                                         jnp.zeros((1, 32, 32, 3)), mode="cam"))
    path = tmp_path / "model_0.msgpack"
    path.write_bytes(flax.serialization.to_bytes(v))

    got = read_flax_msgpack(str(path))
    want_leaves = jax.tree_util.tree_flatten_with_path(v)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0])
    assert len(got_leaves) == len(want_leaves)
    for p, w in want_leaves:
        g = got_leaves[p]
        assert str(g.dtype).split(".")[-1] == w.dtype.name, p
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=jax.tree_util.keystr(p))

    model = MuSCLe(backbone_name="efficientnet-b1", mode="enc", last_pooling=False)
    load_model_state(str(path), model)
    assert model.fc.weight.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    sd = model.state_dict()
    for k, t in state_dict_from_jax(v).items():
        assert sd[k].dtype == t.dtype and torch.equal(sd[k], t), k


def test_msgpack_reader_needs_no_msgpack_package(tmp_path):
    """A process in which ``import msgpack`` fails reads the file."""
    path = tmp_path / "m.msgpack"
    path.write_bytes(flax.serialization.to_bytes(
        {"params": {"k": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
                    "b": np.float32([1.5, -2.0])}}))
    code = ("import sys; sys.modules['msgpack'] = None\n"
            "from muscle_tpu_torch.convert import read_flax_msgpack\n"
            f"t = read_flax_msgpack({str(path)!r})\n"
            "assert t['params']['k'].tolist() == [[0, 1, 2], [3, 4, 5]], t\n"
            "assert t['params']['b'].tolist() == [1.5, -2.0], t\n"
            "assert 'msgpack' not in [m for m in sys.modules if sys.modules[m] is not None]\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
