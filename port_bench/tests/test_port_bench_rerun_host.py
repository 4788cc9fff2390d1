"""The metric of the reads the BWA pipeline's SMEM retry hands to the
native host engine: it reads its value from a synthetic record (counter
``anatomy["rerun_host_reads"]``), and None where a program has no such
counter."""

import pytest

from port_bench.manifest import Manifest

NAME = "bwa.rerun_host_read_pct"


def _rec(anatomy=None, items=32768, reads=32768):
    return dict(items=items, calls=2, inputs=dict(bwa_reads=reads, bwa_host_reads=0),
                delta=dict(timers={}, anatomy=anatomy or {}, launches={}))


@pytest.fixture(scope="module")
def man():
    return Manifest()


def test_it_reads_the_counter(man):
    got = man.metric(NAME).read(_rec(anatomy={"rerun_reads": 5283, "rerun_host_reads": 3}))
    assert got == pytest.approx(100 * 3 / 32768)
    assert man.metric(NAME).read(_rec(anatomy={"rerun_reads": 5283,
                                               "rerun_host_reads": 0})) == 0.0


@pytest.mark.parametrize("rec", [
    _rec(anatomy={"rerun_reads": 5283, "smem_s": 1.0}),
    _rec(anatomy={"rerun_host_reads": 3}, items=0, reads=0),
], ids=["absent", "no-reads"])
def test_a_program_without_the_counter_reads_none(man, rec):
    assert man.metric(NAME).read(rec) is None


def test_the_metric_is_declared_for_uniform(man):
    entry = next(m for m in man.data["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["bwamem_chr20.uniform"]
    assert entry["layer"] == "Models" and entry["moves"] == "reads_per_s"
    assert entry["source"] == "program_counter"
