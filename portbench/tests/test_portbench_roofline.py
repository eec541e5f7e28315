"""The roofline's work counts equal hand counts, the trace reduction's
interval arithmetic, the card's kernel time a proof, and a run that has
nothing to read fails."""

import pytest

from portbench.bench import roofline
from portbench.bench.metrics import read_all, read_end_to_end
from portbench.bench.registry import Registry
from portbench.bench.trace import Spans, align, breakdown, busy_and_gaps, union_seconds


def test_blake2b_compressions():
    for length, blocks in [(0, 1), (128, 1), (129, 2), (256, 2), (257, 3)]:
        ops, nbytes = roofline.blake2b_work([length])
        assert ops == blocks * 1360
        assert nbytes == length + 32


def test_keccak_absorbed_blocks():
    for length, blocks in [(0, 1), (64, 1), (135, 1), (136, 2), (272, 3)]:
        ops, nbytes = roofline.keccak_work([length])
        assert ops == blocks * 4354
        assert nbytes == length + 32


def test_bound_is_the_larger():
    assert roofline.ALU_OPS_PER_S == 67e12 / 256 * 64
    ops, nbytes = roofline.keccak_work([64] * 65536)
    assert roofline.bound_seconds(ops, nbytes) == ops / roofline.ALU_OPS_PER_S
    assert roofline.bound_seconds(0, 3.35e12) == 1.0


def test_busy_gaps_and_breakdown():
    ops = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("copy", 5.0, 6.0), ("late", 9.0, 12.0)]
    busy, gaps = busy_and_gaps(ops, (0.0, 10.0))
    assert busy == 4.0 and gaps == [(2.0, 5.0), (6.0, 9.0)]
    assert union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    spans = Spans()
    spans.add("unit", 0.0, 10.0)
    spans.add("verify_block_cids", 2.5, 4.0)
    out = breakdown(ops, gaps, spans)
    assert out["device_ops"][0] == ["late", 3.0]
    assert dict(out["idle_gaps"]) == {"verify_block_cids": 3.0, "unit": 3.0}


MARKER_NAME = "void at::cuda::(anonymous namespace)::spin_kernel(long)"


def test_trace_without_the_marker_raises():
    with pytest.raises(RuntimeError, match="marker"):
        align([("blake2b256_quad_kernel", 0, 1000)], 1.0)
    with pytest.raises(RuntimeError, match="marker"):
        align([], 1.0)


def test_clock_is_tied_to_the_marker_not_the_first_event():
    events = [("early_copy", 500, 700), (MARKER_NAME, 1000, 2000), ("kernel", 3000, 4000)]
    ops = align(events, 10.0)  # the marker ends (2,000 ns) as the host reads 10.0 s
    assert [name for name, _, _ in ops] == ["early_copy", "kernel"]
    assert ops[1][1] == pytest.approx(10.0 + 1e-6) and ops[1][2] == pytest.approx(10.0 + 2e-6)
    assert ops[0][1] == pytest.approx(10.0 - 1.5e-6)


def _record(ops, **change):
    record = {"units": 40, "proofs": 26240, "clients": 1, "unit_seconds": [0.05] * 40,
              "window": (10.0, 12.0), "launches": 120,
              "stages": {"range_scan": {"wall_s": 0.9}, "range_record": {"wall_s": 0.6}},
              "spans": {"verify_block_cids": [(10.1, 10.2)]},
              "hashed": {"blake2b": [100] * 500, "keccak": []}, "host": {"gc_pause_s": 0.02},
              "device_ops": ops}
    record.update(change)
    return record


def test_a_trace_of_the_marker_alone_fails_the_traced_run(tiny_root):
    reg = Registry(tiny_root)
    cell = reg.cell("topdown_range_4k.gen_verify")
    ops = align([(MARKER_NAME, 0, 1000)], 10.0)
    assert ops == []
    with pytest.raises(RuntimeError, match="no device operation"):
        read_all(reg, cell, _record(ops), Spans())
    late = [("blake2b256_quad_kernel", 12.5, 12.6)]  # only after the window
    with pytest.raises(RuntimeError, match="no device operation"):
        read_all(reg, cell, _record(late), Spans())


def test_a_listed_metric_that_reads_nothing_fails_the_traced_run(tiny_root):
    reg = Registry(tiny_root)
    cell = reg.cell("topdown_range_4k.gen_verify")
    ops = [("blake2b256_quad_kernel", 10.5, 10.5001)]
    values, busy, _ = read_all(reg, cell, _record(ops), Spans())
    assert set(values) == {m["name"] for m in cell.per_layer}
    assert busy == pytest.approx(1e-4)
    with pytest.raises(RuntimeError, match="kernel.blake2b_roofline_pct"):
        read_all(reg, cell, _record(ops, hashed={"blake2b": []}), Spans())


def test_kernel_time_a_proof_leaves_out_copies(tiny_root):
    reg = Registry(tiny_root)
    ops = [("Memcpy HtoD (Pageable -> Device)", 10.1, 10.3), ("Memset (Device)", 10.4, 10.5),
           ("blake2b256_quad_kernel", 10.5, 10.5 + 2e-5), ("late_kernel", 12.5, 12.6)]
    record = _record(ops, proofs=1000, setup_s=7.5, window_s=2.0)
    cell = reg.cell("topdown_range_4k.gen_verify")
    values = read_end_to_end(reg, cell, record, device_traced=True)
    assert set(values) == {"kernel_us_per_kproof", "setup_s"}
    assert values["kernel_us_per_kproof"]["value"] == pytest.approx(20.0)  # 20 us, 1,000 proofs
    assert values["setup_s"] == {"value": 7.5, "unit": "s"}
    assert reg.metric("kernel_us_per_kproof").read(_record(ops[:2], proofs=1000)) is None
    # without the card's timeline (the CPU) the device-trace metric is left out
    plain = read_end_to_end(reg, cell, _record([], setup_s=7.5, window_s=2.0), device_traced=False)
    assert set(plain) == {"setup_s"}


def test_an_untraced_window_the_card_ran_nothing_in_fails(tiny_root):
    reg = Registry(tiny_root)
    cell = reg.cell("topdown_range_4k.gen_verify")
    with pytest.raises(RuntimeError, match="no device operation"):
        read_end_to_end(reg, cell, _record([], setup_s=7.5, window_s=2.0), device_traced=True)
    copies = [("Memcpy HtoD (Pageable -> Device)", 10.1, 10.3)]
    with pytest.raises(RuntimeError, match="kernel_us_per_kproof"):
        read_end_to_end(reg, cell, _record(copies, setup_s=7.5, window_s=2.0), device_traced=True)
