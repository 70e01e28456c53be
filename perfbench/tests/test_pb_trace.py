"""The trace reduction on hand-made profiler events."""
from types import SimpleNamespace as NS

import pytest

from perfbench.trace import Trace, is_kernel


def ev(name, dev, start, end, thread=1, parent=None, kernels=(), children=()):
    return NS(name=name, device_type="DeviceType." + dev, time_range=NS(start=start, end=end),
              is_user_annotation=name.startswith("pb.") and dev == "CUDA", thread=thread,
              cpu_parent=parent, kernels=list(kernels), cpu_children=list(children))


def make():
    k = NS(name="k", duration=3.0)
    child = ev("aten::mm", "CPU", 12, 14, kernels=[k])
    opt = ev("pb.optimizer", "CPU", 11, 20, children=[child],
             kernels=[NS(name="pb.optimizer", duration=50.0)])
    child.cpu_parent = opt
    events = [
        ev("pb.window", "CPU", 0, 100),
        ev("pb.window", "CUDA", 1, 99),
        ev("pb.tick", "CPU", 1, 40),
        opt, child,
        ev("gemm", "CUDA", 10, 20), ev("softmax", "CUDA", 15, 25),
        ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 30, 31),
        ev("gemm", "CUDA", 50, 60),
        ev("Memset (Device)", "CUDA", 60, 61),
        ev("Memcpy DtoH (Device -> Pageable)", "CUDA", 70, 72),
        ev("gemm", "CUDA", 80, 82),
    ]
    return Trace.of(NS(events=lambda: events), attribute=("pb.optimizer",))


def test_card_ops_and_ranges():
    tr = make()
    assert [o[2] for o in tr.ops][:2] == ["gemm", "softmax"]
    assert "pb.window" not in [o[2] for o in tr.ops]
    assert tr.ranges["pb.tick"] == [(1, 40)]


def test_busy_union_and_gaps():
    tr = make()
    # [10, 25] [30, 31] [50, 61] [70, 72] [80, 82]
    assert tr.busy_us() == 15 + 1 + 11 + 2 + 2
    assert tr.gaps() == [(25, 30), (31, 50), (61, 70), (72, 80)]


def test_kernels_are_told_from_memsets_and_copies():
    assert is_kernel("gemm") and not is_kernel("Memset (Device)")
    assert not is_kernel("Memcpy DtoH (Device -> Pageable)")


def test_attribution_follows_links_and_skips_range_copies():
    assert make().attributed["pb.optimizer"] == 3.0


def test_breakdown_labels_idle_gaps_by_host_activity():
    bd = make().breakdown()
    assert bd["device_ops"][0][0] == "gemm"
    assert bd["device_ops"][0][1] == pytest.approx((10 + 10 + 2) / 1e6)
    labels = dict(bd["idle_gaps"])
    # gap midpoints: 27.5 in the tick, 40.5, 65.5 and 76 in the window alone
    assert labels["pb.tick / python"] == pytest.approx(5 / 1e6)
    assert labels["pb.window / python"] == pytest.approx((19 + 9 + 8) / 1e6)


def _decode_record(lose_copy: bool):
    from perfbench.trace import Trace
    ops = []
    for t in range(4):                     # four decode ticks: 3 kernels, 1 copy each
        base = 100 * t
        ops += [(base, base + 10, "gemm"), (base + 10, base + 12, "flash_decode_sm90_kernel<128, 2>"),
                (base + 12, base + 20, "gemm")]
        if not (lose_copy and t == 1):
            ops.append((base + 20, base + 21, "Memcpy DtoH (Device -> Pageable)"))
    tr = Trace(ops, {}, [], {})
    ctx = NS(conf={"num_attention_heads": 96, "num_key_value_heads": 8, "head_dim": 128},
             traffic={"clients": 32, "trace": {"decode_ticks": 4, "skip": 1}})
    peaks = {"bf16_flop_s": 989e12, "hbm_byte_s": 3.35e12}
    return {"ctx": ctx, "trace": tr, "peaks": peaks,
            "seg": {"ticks": [{"clen": 1000 + t} for t in range(4)]}}


@pytest.mark.parametrize("lose_copy", [False, True])
def test_decode_metrics_read_the_whole_segment(lose_copy):
    from perfbench import bench, counts
    r = _decode_record(lose_copy)
    read = lambda name: bench.metric_reader(name)(name, r)
    assert read("launches_per_step.gen") == 3.0
    busy = 4 * 21 - (1 if lose_copy else 0)
    assert read("decode_busy_ms.gen") == pytest.approx(busy / 4 / 1e3)
    f, b = counts.flash_decode(32, 96, 8, 128, 1001.5)
    want = 100 * 4 * counts.roofline_s(f, b, r["peaks"]) / (4 * 2e-6)
    assert read("flash_decode_sm90_roofline.gen") == pytest.approx(want, rel=2e-3)


def test_the_profile_attributes_what_the_cells_metric_files_name():
    from perfbench import bench, harness
    b = bench.benchmark()
    train = harness.attributed_names(bench.per_layer_of(b, "olmo-1b.pretrain_8x2k"))
    assert train == ["FlashAttentionFnBackward"]
    assert harness.attributed_names(bench.per_layer_of(b, "command-r-plus-104b-l8.chat_1k_256")) == []
