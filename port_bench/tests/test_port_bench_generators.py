"""The seeded generators: the same seed gives the same inputs, at the
configured shapes."""

import json
import os

import numpy as np
import pytest

from conftest import BENCH
from port_bench.gen.genome import make_genome
from port_bench.gen.reads import make_reads
from port_bench.gen.regions import make_regions
from port_bench.kinds.common import seed_words


def _cfg(name):
    return json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))


def _mix(name):
    return json.load(open(os.path.join(BENCH, "traffic", f"{name}.json")))


@pytest.fixture(scope="module")
def small_genome():
    spec = _cfg("bwamem_chr20")["genome"]
    spec = dict(spec, length=400_000,
                families=dict(spec["families"], segdup=dict(spec["families"]["segdup"],
                                                            len=[1000, 8000])))
    return spec, make_genome(spec)


def test_regions_reproducible_and_at_the_configured_shapes():
    cfg = _cfg("gatk_hc_wgs30x")
    a = make_regions(np.random.default_rng(seed_words(2**33 + 5)), cfg, 40)
    b = make_regions(np.random.default_rng(seed_words(2**33 + 5)), cfg, 40)
    r = cfg["region"]
    for (ra, ha, rda), (rb, hb, rdb) in zip(a, b):
        assert np.array_equal(ra, rb) and len(ha) == len(hb)
        assert all(np.array_equal(x, y) for x, y in zip(ha, hb))
        assert all(np.array_equal(x["rs"], y["rs"]) and np.array_equal(x["q"], y["q"])
                   for x, y in zip(rda, rdb))
        w = len(ra) - 2 * r["padding"]
        assert r["active_min"] <= w <= r["active_max"]
        nh = len(ha)
        assert 2 <= nh <= cfg["variants"]["max_haplotypes"] and nh & (nh - 1) == 0
        assert np.array_equal(ha[0], ra)
        assert len({h.tobytes() for h in ha}) == nh
        assert all(r["min_read_len"] <= len(x["rs"]) <= r["read_len"] for x in rda)
        assert all(len(x[k]) == len(x["rs"]) for x in rda for k in "qidc")
        assert all(set(np.unique(x["q"])) <= {2, 12, 23, 37} for x in rda)
        assert all((x["i"] == 45).all() and (x["d"] == 45).all() and (x["c"] == 10).all()
                   for x in rda)
    c = make_regions(np.random.default_rng(seed_words(6)), cfg, 40)
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    # reads hard-clipped to the window: about coverage x window bases a region
    depth = np.mean([sum(len(x["rs"]) for x in rd) / (30 * len(rf)) for rf, _, rd in a])
    assert 0.9 < depth < 1.1
    lens = np.concatenate([[len(x["rs"]) for x in rd] for _, _, rd in a])
    assert (lens < r["read_len"]).mean() > 0.2


def test_haplotypes_are_the_combinations_of_the_sites():
    from port_bench.gen.regions import _haplotypes, _sites

    cfg = _cfg("gatk_hc_wgs30x")
    v = dict(cfg["variants"], rate=0.02, indel_share=0.5)
    rng = np.random.default_rng(3)
    ref = rng.integers(0, 4, 400).astype(np.uint8)
    sites = _sites(rng, 200, 100, v)
    assert 1 <= len(sites) <= 7
    assert all(b[0] - a[0] >= 4 for a, b in zip(sites, sites[1:]))
    haps = _haplotypes(rng, ref, sites)
    assert len(haps) == 2 ** len(sites) and np.array_equal(haps[0], ref)
    for h, hap in enumerate(haps):
        dl = sum((ln if k == 1 else -ln) for i, (_, k, ln) in enumerate(sites) if h >> i & 1)
        assert len(hap) == len(ref) + dl


def test_haplotype_counts_follow_the_variant_rate():
    cfg = _cfg("gatk_hc_wgs30x")
    regs = make_regions(np.random.default_rng(seed_words(11)), cfg, 600)
    share2 = np.mean([len(h) == 2 for _, h, _ in regs])
    mean_w = np.mean([len(rf) for rf, _, _ in regs])
    assert abs(share2 - np.exp(-cfg["variants"]["rate"] * mean_w)) < 0.07


def test_genome_is_n_free_with_its_families(small_genome):
    spec, (g, copies) = small_genome
    g2, _ = make_genome(spec)
    assert np.array_equal(g, g2) and len(g) == spec["length"] and g.max() <= 3
    for fam, f in spec["families"].items():
        starts, lens = copies[fam]
        share = lens.sum() / len(g)
        assert f["fraction"] <= share < f["fraction"] * 1.5 + 0.01, fam
        assert (starts >= 0).all() and (starts + lens <= len(g)).all()
    assert (copies["alu"][1] == 300).all()


@pytest.mark.parametrize("mix", ["uniform", "repeats"])
def test_reads_reproducible_and_at_the_configured_shapes(small_genome, mix):
    _, (g, copies) = small_genome
    m = _mix(mix)
    a = make_reads(np.random.default_rng(seed_words(2**40 + 3)), g, copies, m, 3000)
    b = make_reads(np.random.default_rng(seed_words(2**40 + 3)), g, copies, m, 3000)
    assert np.array_equal(a, b) and a.shape == (3000, m["read_len"]) and a.max() <= 4
    assert 0.0002 < (a == 4).mean() < 0.003


def test_repeat_reads_start_inside_planted_copies(small_genome):
    from port_bench.gen.reads import read_starts

    _, (g, copies) = small_genome
    m = _mix("repeats")
    st = read_starts(np.random.default_rng(1), 2000, len(g), 153, m, copies)
    inside = np.zeros(len(g), bool)
    for fam in m["families"]:
        for s, ln in zip(*copies[fam]):
            inside[s:s + ln] = True
    assert inside[st].all()


def test_seed_words_take_any_whole_number():
    assert seed_words(2**31 + 7) != seed_words(7)
    assert seed_words(-5) != seed_words(5)
    np.random.default_rng(seed_words(-(2**70)))
