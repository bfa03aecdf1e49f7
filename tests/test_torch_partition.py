"""Port vs reference: flat parameter layout (shape arithmetic only).

A flat buffer the reference makes must load into the port unchanged, so
the port's ``ParamSpec`` entries, offsets and padded sizes and its
``Model.param_shapes`` must equal the reference's, at full width and
reduced, for every dense config the port carries.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np                                           # noqa: E402
import pytest                                                # noqa: E402

from repro.configs import get_config as jax_get_config       # noqa: E402
from repro.core import partition as jpart                    # noqa: E402
from repro.core.zeropp import ZeroConfig as JaxZeroConfig    # noqa: E402
from repro.models.model import Model as JaxModel             # noqa: E402

from repro_torch.configs import get_config                   # noqa: E402
from repro_torch.core import partition as tpart              # noqa: E402
from repro_torch.core.zeropp import ZeroConfig               # noqa: E402
from repro_torch.models.model import Model                   # noqa: E402


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gpt-350m"])
def test_param_layout_matches_reference(arch, world, reduced):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    axes = ("model",)
    jm = JaxModel(jcfg, JaxZeroConfig(dp_axes=axes), world=world)
    tm = Model(tcfg, ZeroConfig(dp_axes=axes), world=world, device="cpu")
    assert tm.param_shapes() == jm.param_shapes()
    assert (tm.unemb_chunks, tm.vchunk) == (jm.unemb_chunks, jm.vchunk)
    for name in ("period_spec", "embed_spec", "head_spec", "unemb_spec"):
        js, ts = getattr(jm, name), getattr(tm, name)
        assert ts.entries == js.entries, name
        assert ts.offsets == js.offsets, name
        assert (ts.size, ts.padded_size, ts.align) == \
            (js.size, js.padded_size, js.align), name


def test_qwen3_full_width_shapes():
    """The buffers the card's engine phase runs (751.6 M parameters)."""
    m = Model(get_config("qwen3-0.6b"), ZeroConfig(dp_axes=("model",)),
              device="cpu")
    shapes = m.param_shapes()
    assert shapes == {"embed": (155582464,), "blocks": (28, 15730944),
                      "head": (1024,), "unemb": (4, 38895616)}
    assert sum(int(np.prod(s)) for s in shapes.values()) == 751_632_384


@pytest.mark.parametrize("world,blocks", [(1, (256,)), (8, (256, 256, 2)),
                                          (6, (128, 96))])
def test_alignment_and_shard_of(world, blocks):
    assert tpart.alignment(world, *blocks) == jpart.alignment(world, *blocks)
    flat = np.arange(world * 12)
    for r in range(world):
        np.testing.assert_array_equal(tpart.shard_of(flat, r, world),
                                      jpart.shard_of(flat, r, world))


def test_unpack_views_in_reference_order():
    import torch
    spec = tpart.ParamSpec((("a", (2, 3)), ("b", (4,)), ("c", ())), align=16)
    flat = torch.arange(spec.padded_size, dtype=torch.float32)
    parts = spec.unpack(flat)
    assert spec.padded_size == 16 and spec.size == 11
    assert parts["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert parts["b"].tolist() == [6, 7, 8, 9]
    assert float(parts["c"]) == 10.0
    parts["b"][0] = -1.0                          # views into the buffer
    assert float(flat[6]) == -1.0
