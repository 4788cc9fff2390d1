"""The metrics of the BWA pipeline's native SMEM rerun: each reads its
value from a synthetic record (span ``bwa.pipe.rerun``, counter
``anatomy["rerun_reads"]``), and None where a program has neither."""

import pytest

from port_bench.manifest import Manifest

RERUN = ("bwa.rerun_ms_per_kread", "bwa.rerun_read_pct")


def _rec(timers=None, anatomy=None, items=32768, reads=32768):
    return dict(items=items, calls=2, inputs=dict(bwa_reads=reads, bwa_host_reads=0),
                delta=dict(timers=timers or {}, anatomy=anatomy or {}, launches={}))


@pytest.fixture(scope="module")
def man():
    return Manifest()


def test_rerun_ms_reads_the_span(man):
    rec = _rec(timers={"bwa.pipe.rerun": {"total_s": 0.5, "count": 2},
                       "bwa.pipe.smem": {"total_s": 9.0, "count": 2}})
    # 0.5 s over 32.768 thousand reads
    assert man.metric("bwa.rerun_ms_per_kread").read(rec) == pytest.approx(500 / 32.768)


def test_rerun_pct_reads_the_counter(man):
    rec = _rec(anatomy={"rerun_reads": 5283, "smem_s": 1.0})
    assert man.metric("bwa.rerun_read_pct").read(rec) == pytest.approx(100 * 5283 / 32768)
    assert man.metric("bwa.rerun_read_pct").read(_rec(anatomy={"rerun_reads": 0})) == 0.0


@pytest.mark.parametrize("name", RERUN)
@pytest.mark.parametrize("rec", [
    _rec(anatomy={"smem_s": 1.0}, timers={"bwa.pipe.smem": {"total_s": 1.0, "count": 2}}),
    _rec(timers={"bwa.pipe.rerun": {"total_s": 0.0, "count": 0}}),
    _rec(anatomy={"rerun_reads": 3}, timers={"bwa.pipe.rerun": {"total_s": 0.1, "count": 1}},
         items=0, reads=0),
], ids=["absent", "never-opened", "no-reads"])
def test_a_program_without_the_rerun_reads_none(man, name, rec):
    assert man.metric(name).read(rec) is None


@pytest.mark.parametrize("name", RERUN)
def test_the_metric_is_declared_for_uniform(man, name):
    entry = next(m for m in man.data["per_layer"] if m["name"] == name)
    assert entry["workloads"] == ["bwamem_chr20.uniform"]
    assert entry["layer"] == "Models" and entry["moves"] == "reads_per_s"
