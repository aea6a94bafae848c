"""Port parity of the shape data (the conv zoo, ``all_model_shapes`` and
the CSV writer ``main``), the storage packing of 2:4 codes
(``pack_codes`` / ``unpack_codes``) and the trace helpers.

The shape lists must equal the JAX package's and the committed
``datasets/*.csv``; ``main`` must write the same bytes as the JAX
``main``. The code packing must be bit-identical to the JAX one.
"""

import filecmp
import json
import pathlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import sparsifyme_tpu_torch as sp
from sparsifyme_tpu.models import conv_zoo as jzoo
from sparsifyme_tpu.models import resnet_shapes as jrs
from sparsifyme_tpu.ops import sparse24 as js
from sparsifyme_tpu_torch.models import conv_zoo as tzoo
from sparsifyme_tpu_torch.models import resnet_shapes as trs
from sparsifyme_tpu_torch.utils import trace
from sparsifyme_tpu_torch.utils.shapes import read_shapes

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODELS = sorted(p.stem for p in (ROOT / "datasets").glob("*.csv")
                if p.stem != "shapes")


# --------------------------------------------------------------------------
# Shape data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("image_size", [224, 244])
@pytest.mark.parametrize("batch", [32, 1])
def test_conv_zoo_matches_jax(image_size, batch):
    kw = dict(image_size=image_size, batch=batch)
    assert (tzoo.mobilenet_v2_conv_shapes(**kw)
            == jzoo.mobilenet_v2_conv_shapes(**kw))
    for variant in ("small", "large"):
        assert (tzoo.mobilenet_v3_conv_shapes(variant, **kw)
                == jzoo.mobilenet_v3_conv_shapes(variant, **kw))
    for name in ("densenet161", "densenet201"):
        assert (tzoo.densenet_conv_shapes(name, **kw)
                == jzoo.densenet_conv_shapes(name, **kw))
    assert tzoo.zoo_conv_shapes(batch) == jzoo.zoo_conv_shapes(batch)


@pytest.mark.parametrize("name", MODELS)
def test_all_model_shapes_match_jax_and_the_datasets(name):
    got = trs.all_model_shapes()
    assert list(got) == list(jrs.all_model_shapes())
    assert got[name] == jrs.all_model_shapes()[name]
    assert got[name] == read_shapes(str(ROOT / "datasets" / f"{name}.csv"))


def test_main_writes_the_jax_csvs(tmp_path):
    """The same files, byte for byte, as the JAX ``main``, and as the
    committed datasets."""
    trs.main([str(tmp_path / "port")])
    jrs.main([str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (ROOT / "datasets").glob("*.csv"))
    for n in names:
        assert filecmp.cmp(tmp_path / "port" / n, tmp_path / "jax" / n,
                           shallow=False), n
        assert filecmp.cmp(tmp_path / "port" / n, ROOT / "datasets" / n,
                           shallow=False), n


def test_main_takes_the_batch(tmp_path):
    trs.main([str(tmp_path / "port"), "--batch", "8"])
    jrs.main([str(tmp_path / "jax"), "--batch", "8"])
    got = read_shapes(str(tmp_path / "port" / "mobilenetv2.csv"))
    assert {s.b for s in got} == {8}
    assert filecmp.cmp(tmp_path / "port" / "shapes.csv",
                       tmp_path / "jax" / "shapes.csv", shallow=False)


# --------------------------------------------------------------------------
# pack_codes / unpack_codes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("k4", [1, 2, 7, 16, 33])
def test_pack_codes_matches_jax(rng, lead, k4):
    """Bit-identical to the JAX packing, odd group counts padded alike,
    and ``unpack_codes`` gives the codes back."""
    codes = rng.integers(0, 16, size=(*lead, k4, 10)).astype(np.uint8)
    want = np.asarray(js.pack_codes(jnp.asarray(codes)))
    got = sp.pack_codes(torch.from_numpy(codes))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    back = sp.unpack_codes(got, k4)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(js.unpack_codes(jnp.asarray(want), k4)))


def test_pack_codes_of_compressed_planes(rng):
    """The codes of a real compress: every 2:4 code survives the trip."""
    a = torch.from_numpy(rng.normal(size=(48, 147)).astype(np.float32))
    s = sp.compress_24(sp.prune_24(a)[0])
    packed = sp.pack_codes(s.codes)
    assert tuple(packed.shape) == (-(-s.k4 // 2), 48)
    assert torch.equal(sp.unpack_codes(packed, s.k4), s.codes)


# --------------------------------------------------------------------------
# Trace helpers
# --------------------------------------------------------------------------

@trace.annotate()
def _annotated_matmul(a):
    return a @ a


@trace.annotate("named-by-hand")
def _renamed(a):
    return a + 1


def test_profile_trace_writes_the_named_ranges(tmp_path):
    """A CPU ``profile_trace`` writes a chrome trace that holds the
    ``trace_range`` and ``annotate`` names."""
    a = torch.ones((8, 8))
    with trace.profile_trace(str(tmp_path)) as prof:
        with trace.trace_range("outer-range"):
            _annotated_matmul(a)
            _renamed(a)
    data = json.loads((tmp_path / trace.TRACE_FILE).read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert {"outer-range", "_annotated_matmul",
            "named-by-hand"} <= names
    assert trace.busy_share(prof) == 0.0  # no device on the CPU


def test_annotate_keeps_the_function():
    assert _annotated_matmul.__name__ == "_annotated_matmul"
    assert torch.equal(_renamed(torch.zeros(2)), torch.ones(2))


def test_union_length():
    assert trace.union_length([]) == 0.0
    assert trace.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert trace.union_length([(4, 8), (0, 10), (2, 3)]) == 10.0


def _event(start, end, device):
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end),
                           device_type=device)


def test_busy_share_on_a_synthetic_trace():
    """The union of the device's intervals over the span of all events:
    host events [0, 100], device [10, 30] and [20, 40] overlapping, [90,
    110] past the host's last event -> 50 busy of 110."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    prof = SimpleNamespace(events=lambda: [
        _event(0, 100, cpu), _event(10, 30, cuda), _event(20, 40, cuda),
        _event(90, 110, cuda), _event(50, 60, cpu)])
    assert trace.busy_share(prof) == pytest.approx(50 / 110)
    assert trace.busy_share(SimpleNamespace(events=lambda: [])) == 0.0
