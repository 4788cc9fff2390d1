"""The PairHMM byte-plane gather on the CPU (its plain PyTorch version).

The flat route uploads a batch's read and haplotype streams once and
builds every bucket's time-major byte planes on the device
(``ops/pairhmm/gather.py``).  Its planes must be the native host pack's
(``native.pairhmm_pack_quals_flat``) byte for byte, so the forward kernel
sees the same inputs; the engine's flat route must then equal its dict
route, whose planes are packed in Python, bit for bit.
"""

import numpy as np
import pytest
import torch

from acc_genomics_tpu_torch.build import ensure_native
from acc_genomics_tpu_torch.config import PairHMMConfig, SWConfig
from acc_genomics_tpu_torch.engine.pairhmm_engine import PairHMMEngine
from acc_genomics_tpu_torch.engine.sw_engine import SWEngine
from acc_genomics_tpu_torch.io.synth import gen_pairhmm_input, gen_region
from acc_genomics_tpu_torch.models import HaplotypeCallerCore, HCEngines
from acc_genomics_tpu_torch.ops.pairhmm.gather import TABLE_COLS, GatherLayout, pairhmm_gather
from acc_genomics_tpu_torch.tools.bench_shapes import GATHER_CASES, gather_case, native_planes


def _gathered(case, seed):
    ensure_native()
    streams, offs, lens, hoffs, hlens, groups = gather_case(
        np.random.default_rng(seed), *GATHER_CASES[case])
    layout = GatherLayout.plan([(rows, cols, len(sel)) for sel, rows, cols in groups],
                               [len(s) for s in streams])
    hv = np.empty(layout.nbytes, np.uint8)
    layout.fill(hv, streams, offs, lens, hoffs, hlens, [sel for sel, _, _ in groups])
    dev = torch.from_numpy(hv)
    return layout, dev, pairhmm_gather(dev, layout), (streams, offs, lens, hoffs, hlens, groups)


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_gather_equals_the_native_pack(case):
    """Every bucket's region, in launch order, the native pack's bytes;
    each bucket's lens and hlens views the lanes' lengths."""
    layout, dev, planes, batch = _gathered(case, 3)
    _, _, lens, _, hlens, groups = batch
    assert planes.dtype == torch.uint8 and planes.numel() == layout.planes_bytes
    assert np.array_equal(planes.numpy(), native_planes(*batch))
    for b, (sel, rows, cols) in enumerate(groups):
        views = layout.bucket(b, planes, dev)
        assert [tuple(v.shape) for v in views[:6]] == [(rows, len(sel))] * 5 + [
            (rows + cols, len(sel))]
        assert np.array_equal(views[6].numpy(), lens[sel])
        assert np.array_equal(views[7].numpy(), hlens[sel])


def test_layout_places_each_piece_once():
    """The upload: offs and hoffs of every lane, the table, meta, then the
    six streams unpadded; the regions back to back."""
    shapes = [(192, 512, 70), (32, 128, 1), (576, 1024, 3)]
    layout = GatherLayout.plan(shapes, [10, 10, 10, 10, 10, 7])
    lanes = 74
    assert layout.lanes == lanes
    assert layout.table.shape == (3, TABLE_COLS)
    assert layout.table[:, 0].tolist() == [0, 1664 * 70, 1664 * 70 + 320]
    assert layout.table[:, 4].tolist() == [0, 70, 71]
    assert layout.planes_bytes == 1664 * 70 + 320 + (6 * 576 + 1024) * 3
    assert layout.table_at == 16 * lanes
    assert layout.meta_at == layout.table_at + 8 * 3 * TABLE_COLS
    assert layout.stream_at == tuple(layout.meta_at + 8 * lanes + k for k in
                                     (0, 10, 20, 30, 40, 50, 57))
    assert layout.nbytes == layout.stream_at[-1]


@pytest.mark.parametrize("bad", ["short", "int32", "2d"])
def test_gather_refuses_a_bad_upload(bad):
    layout, dev, _, _ = _gathered("empty", 1)
    upload = {"short": dev[:-1], "int32": dev[: dev.numel() // 4 * 4].view(torch.int32),
              "2d": dev.view(1, -1)}[bad]
    with pytest.raises(ValueError, match="upload"):
        pairhmm_gather(upload, layout)


@pytest.mark.parametrize("buckets", [
    ((32, 64, 128), (64, 128, 256)),
    ((320, 576), (512, 1024)),
], ids=["illumina", "hifi"])
def test_flat_route_equals_the_dict_route(buckets):
    """compute_matrix_flat (planes gathered from the unique streams)
    against compute_matrix (planes packed in Python), bit for bit, on
    several buckets; every device pair counted in ``card_packed``."""
    rows, cols = buckets
    rng = np.random.default_rng(len(rows))
    reads, haps = gen_pairhmm_input(rng, 24, 4, max_read_len=rows[-1] - 1,
                                    max_hap_len=cols[-1], derived=True)
    cfg = PairHMMConfig(read_buckets=rows, hap_buckets=cols, quals_expand="gather")
    flat, dict_eng = PairHMMEngine(cfg, device="cpu"), PairHMMEngine(cfg, device="cpu")
    dict_eng.min_device_cells = 0
    cat = lambda key: np.concatenate([r[key] for r in reads])
    got = flat.compute_matrix_flat(
        cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"), [len(r["rs"]) for r in reads],
        np.concatenate(haps), [len(h) for h in haps])
    want = dict_eng.compute_matrix(reads, haps)
    assert flat.stats["device_calls"] > 1
    assert np.array_equal(got, want)
    assert flat.stats["card_packed"] == len(reads) * len(haps)
    assert "card_packed" not in dict_eng.stats


def test_haplotype_caller_counts_card_packed_pairs():
    """``anatomy["card_pack_pairs"]``: the pairs of the device route, not
    those past the buckets (native host forward)."""
    rng = np.random.default_rng(5)
    regions = [gen_region(rng, ref_len=60, n_haps=2, n_reads=4, read_len=rl)[:3]
               for rl in (40, 40, 55)]
    core = HaplotypeCallerCore(HCEngines(
        SWEngine(SWConfig(seq_buckets=(128,)), device="cpu"),
        PairHMMEngine(PairHMMConfig(read_buckets=(32, 48), hap_buckets=(128,)),
                      device="cpu")))
    core.process_regions(regions)
    n = sum(len(h) * len(r) for _, h, r in regions)
    host = core.anatomy["host_pairs"]
    assert core.anatomy["card_pack_pairs"] + host == n
    assert core.anatomy["card_pack_pairs"] > 0 and host > 0
    core.reset_anatomy()
    assert core.anatomy["card_pack_pairs"] == 0


@pytest.mark.parametrize("upload", ["quals", "f32"])
def test_step_spans_open_directly_under_the_call(monkeypatch, upload):
    """The flat call's step spans (``pairhmm.stage``, ``.launch`` and,
    on the byte-plane route, ``.pack`` around the gather) each open
    directly under ``pairhmm.call`` and never inside one another, so the
    per-step metrics and ``pairhmm.self`` add up to the call; ``.pack``
    opens once a call on the byte-plane route and never on the f32
    route."""
    from acc_genomics_tpu_torch.utils.timer import Timer

    ensure_native()
    stack, opened = [], []
    enter, leave = Timer.__enter__, Timer.__exit__

    def spy_enter(self):
        opened.append((self.key, tuple(stack)))
        stack.append(self.key)
        return enter(self)

    def spy_exit(self, *exc):
        assert stack.pop() == self.key
        return leave(self, *exc)

    monkeypatch.setattr(Timer, "__enter__", spy_enter)
    monkeypatch.setattr(Timer, "__exit__", spy_exit)
    rng = np.random.default_rng(8)
    reads, haps = gen_pairhmm_input(rng, 12, 3, max_read_len=100, max_hap_len=200,
                                    derived=True)
    eng = PairHMMEngine(PairHMMConfig(read_buckets=(64, 128), hap_buckets=(256,),
                                      upload=upload), device="cpu")
    cat = lambda key: np.concatenate([r[key] for r in reads])
    eng.compute_matrix_flat(cat("rs"), cat("q"), cat("i"), cat("d"), cat("c"),
                            [len(r["rs"]) for r in reads], np.concatenate(haps),
                            [len(h) for h in haps])
    steps = [(k, up) for k, up in opened
             if k in ("pairhmm.stage", "pairhmm.launch", "pairhmm.pack")]
    assert {k for k, _ in steps} >= {"pairhmm.stage", "pairhmm.launch"}
    assert all(up == ("pairhmm.call",) for _, up in steps), steps
    assert sum(k == "pairhmm.pack" for k, _ in steps) == (upload == "quals")
    assert eng.stats["device_calls"] == 2
