"""Parser plugins of the PyTorch port (data/data_feed.py,
``ParserPluginManager`` / ``load_parser_plugin``) against the JAX
package's.

Both plugin kinds:
* ``"module:factory"``: the port's fixture (tests/
  torch_parser_plugin_fixture.py, which builds the port's
  SlotRecordBlock) parses the same lines as the JAX package's plugin
  path given the same logic; the manager caches the factory per spec;
* ``"lib.so:symbol"``: the port's own native library named as a plugin
  drives the port's ``NativeSlotParser`` through the plugin symbol, and
  its blocks equal the JAX package's plugin parser's (the JAX package's
  library) and the port's built-in parser's, bit for bit.
"""

import ctypes

import numpy as np
import pytest

from paddlebox_tpu.config import DataFeedConfig as JFeed
from paddlebox_tpu.config import SlotConfig as JSlot
from paddlebox_tpu.data import data_feed as jdf
from paddlebox_tpu.native import build as jbuild
from paddlebox_tpu_torch.config import DataFeedConfig as TFeed
from paddlebox_tpu_torch.config import SlotConfig as TSlot
from paddlebox_tpu_torch.data import data_feed as tdf
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.native import build as tbuild
from paddlebox_tpu_torch.native import slot_parser as tnative

FIXTURE = "tests.torch_parser_plugin_fixture"


def configs():
    def slots(Slot):
        return (Slot("label", dtype="float", is_dense=True, dim=1),
                Slot("s0", slot_id=1, capacity=3),
                Slot("s1", slot_id=2, capacity=2))
    return JFeed(slots=slots(JSlot)), TFeed(slots=slots(TSlot))


def lines(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k0 = rng.integers(1, 2**63, rng.integers(1, 4), dtype=np.uint64)
        k1 = rng.integers(1, 2**40, rng.integers(1, 3), dtype=np.uint64)
        out.append(f"1 ins{i} 1 {int(rng.integers(0, 2))} {len(k0)} "
                   + " ".join(map(str, k0)) + f" {len(k1)} "
                   + " ".join(map(str, k1)))
    return out


def assert_same_block(got, want):
    assert got.n == want.n
    assert set(got.uint64_slots) == set(want.uint64_slots)
    assert set(got.float_slots) == set(want.float_slots)
    for side in ("uint64_slots", "float_slots"):
        for k, (v, o) in getattr(want, side).items():
            gv, go = getattr(got, side)[k]
            np.testing.assert_array_equal(gv, v, err_msg=k)
            np.testing.assert_array_equal(go, o, err_msg=k)
    assert got.ins_ids == want.ins_ids


def test_python_factory_builds_the_ports_block():
    _, tcfg = configs()
    parser = tdf.load_parser_plugin(f"{FIXTURE}:create_parser", tcfg)
    block = parser.parse_block(["5 x", "7 y", "9"])
    assert isinstance(block, SlotRecordBlock)
    assert block.n == 3
    np.testing.assert_array_equal(block.uint64_slots["label"][0],
                                  np.array([5, 7, 9], np.uint64))


def test_python_factory_matches_jax_plugin_path():
    """The same spec through each package's manager: the JAX package's
    manager calls the JAX fixture, the port's the port's; both are the
    default-name (``create_parser``) and explicit-name forms."""
    jcfg, tcfg = configs()
    jblock = jdf.load_parser_plugin(
        "tests.parser_plugin_fixture:create_parser", jcfg).parse_block(
            ["ignored line"])
    tblock = tdf.load_parser_plugin(FIXTURE, tcfg).parse_block(["5"])
    assert jblock.n == tblock.n == 1
    name = jcfg.slots[0].name
    np.testing.assert_array_equal(tblock.uint64_slots[name][0],
                                  jblock.uint64_slots[name][0])
    np.testing.assert_array_equal(tblock.uint64_slots[name][1],
                                  jblock.uint64_slots[name][1])


def test_manager_caches_the_factory_per_spec():
    _, tcfg = configs()
    mgr = tdf.ParserPluginManager()
    a = mgr.load(f"{FIXTURE}:other_factory", tcfg)
    b = mgr.load(f"{FIXTURE}:other_factory", tcfg)
    assert a is not b                       # a new parser per load
    assert list(mgr._cache) == [f"{FIXTURE}:other_factory"]


def test_so_plugin_matches_jax_and_builtin():
    if not (tbuild.ensure_built() and jbuild.ensure_built()):
        pytest.skip("no C++ compiler for the native libraries")
    jcfg, tcfg = configs()
    data = lines()
    mgr = tdf.ParserPluginManager()
    parser = mgr.load(f"{tbuild.lib_path()}:pbox_parse_block", tcfg)
    assert isinstance(parser, tnative.NativeSlotParser)
    assert parser._lib is not None and parser._entry == "pbox_parse_block"
    parser.parse_ins_id = True
    got = parser.parse_block(data)

    jparser = jdf.ParserPluginManager().load(
        f"{jbuild.lib_path()}:pbox_parse_block", jcfg)
    jparser.parse_ins_id = True
    assert_same_block(got, jparser.parse_block(data))
    assert_same_block(got, tnative.NativeSlotParser(
        tcfg, parse_ins_id=True).parse_block(data))
    assert_same_block(got, tdf.SlotParser(tcfg, parse_ins_id=True)
                      .parse_block(data))


def test_so_plugin_calls_the_named_symbol():
    """The plugin's symbol, not the built-in entry, parses: a library
    whose named symbol is missing fails at the first parse."""
    if not tbuild.ensure_built():
        pytest.skip("no C++ compiler for the native library")
    _, tcfg = configs()
    parser = tdf.ParserPluginManager().load(
        f"{tbuild.lib_path()}:pbox_no_such_parser", tcfg)
    assert isinstance(parser._lib, ctypes.CDLL)
    with pytest.raises(AttributeError, match="pbox_no_such_parser"):
        parser.parse_block(lines(n=2))
