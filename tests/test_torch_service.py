"""The port's engine service (``parallel/service.py``) on ``device="cpu"``:
the cases of tests/test_service.py (loopback for all four ops, the
client's fallback, a persisted index, ``device_trace``, the CLI daemon
from a ``--conf`` file, concurrent clients), each answer held to the
oracles and to the same engine's direct call, and a JAX ``EngineClient``
talking to a port ``EngineServer`` (the wire's compatibility).

Every server binds port 0 and stops in ``finally``; every client socket
has a timeout, so no test can hang.
"""

import json
import os
import queue
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

from acc_genomics_tpu.parallel.service import EngineClient as JaxEngineClient
from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
from acc_genomics_tpu_torch.io.bwa_index import save_bwa_index
from acc_genomics_tpu_torch.io.synth import (
    gen_pairhmm_input,
    gen_reference_with_repeats,
    gen_smem_reads,
    gen_sw_batch,
)
from acc_genomics_tpu_torch.ops.extend.reference import extend_seed_oracle
from acc_genomics_tpu_torch.ops.pairhmm.reference import pairhmm_loglik_oracle
from acc_genomics_tpu_torch.ops.smem.index import FMIndex
from acc_genomics_tpu_torch.ops.smem.reference import mem_collect_intv_oracle
from acc_genomics_tpu_torch.ops.sw.reference import sw_align_oracle
from acc_genomics_tpu_torch.parallel.service import (
    OP_EXTEND,
    OP_LOAD_REF,
    OP_PAIRHMM,
    OP_SMEM,
    OP_SW,
    EngineClient,
    EngineServer,
)
from acc_genomics_tpu_torch.tools.bench_shapes import flat_matrix_args
from acc_genomics_tpu_torch.utils.timer import device_trace

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TIMEOUT = 120.0  # seconds a request may take on the CPU


@pytest.fixture
def server():
    srv = EngineServer(device="cpu").start()
    try:
        yield srv
    finally:
        srv.stop()


def _client(srv, **kw):
    client = EngineClient(*srv.address, timeout=10.0, device="cpu",
                          request_timeout=TIMEOUT, **kw)
    assert client.connected
    return client


def _seeds(rng, genome, n=5):
    seeds = []
    for _ in range(n):
        pos = int(rng.integers(60, 600))
        read = genome[pos: pos + 80].copy()
        mut = rng.random(80) < 0.05
        read[mut] = (read[mut] + 1) % 4
        read[30:50] = genome[pos + 30: pos + 50]  # a clean seed
        lo = pos - 40
        seeds.append(dict(read=read, rseq=genome[lo: pos + 120], qbeg=30,
                          rbeg_off=pos + 30 - lo, len=20))
    return seeds


def _extend_oracle(seeds):
    return [extend_seed_oracle(s["read"], s["rseq"], s["qbeg"], s["rbeg_off"], s["len"])
            for s in seeds]


def _lik_oracle(reads, haps):
    return np.array([[pairhmm_loglik_oracle(r["rs"], r["q"], r["i"], r["d"], r["c"], h)
                      for h in haps] for r in reads])


def test_loopback_pairhmm_and_smem(server, rng):
    client = _client(server)
    reads, haps = gen_pairhmm_input(rng, 4, 2, max_read_len=30, max_hap_len=60)
    lik = client.pairhmm(reads, haps)
    assert lik.shape == (4, 2)
    np.testing.assert_allclose(lik, _lik_oracle(reads, haps), rtol=5e-3)
    direct = server.engine.pairhmm.compute_matrix_flat(*flat_matrix_args(reads, haps))
    assert lik.tobytes() == direct.tobytes()

    genome = gen_reference_with_repeats(rng, 1200)
    client.load_reference(genome)
    smem_reads = gen_smem_reads(rng, genome, 3, read_len=70)
    smem_reads.append(np.full(30, 4, np.uint8))  # no interval at all
    ivs = client.smem(smem_reads)
    fm = FMIndex.build(genome)
    assert ivs == [mem_collect_intv_oracle(fm, r) for r in smem_reads]
    assert ivs == server.engine.smem_collect(smem_reads)
    assert server.answered == {OP_PAIRHMM: 1, OP_LOAD_REF: 1, OP_SMEM: 1}
    client.shutdown_server()


def test_loopback_sw_and_extend(server, rng):
    client = _client(server)
    ref, alts = gen_sw_batch(rng, 4, ref_len=60)
    for strategy in (0, 3):
        got = client.sw([ref] * len(alts), alts, strategy=strategy)
        assert got == [sw_align_oracle(ref, a, strategy) for a in alts]
        assert got == server.engine.sw.align([ref] * len(alts), alts, strategy)
    genome = gen_reference_with_repeats(rng, 800)
    seeds = _seeds(rng, genome)
    res = client.extend(seeds)
    want = _extend_oracle(seeds)
    assert res == [{k: w[k] for k in r} for r, w in zip(res, want)]
    assert res == server.engine.extend_seeds(seeds)
    assert server.answered == {OP_SW: 2, OP_EXTEND: 1}
    client.close()


def test_engine_error_comes_back_as_an_error(server, rng):
    client = _client(server)
    with pytest.raises(RuntimeError, match="no reference loaded"):
        client.smem(gen_smem_reads(rng, rng.integers(0, 4, 500).astype(np.uint8), 2))
    # the daemon keeps serving after an error
    ref, alts = gen_sw_batch(rng, 2, ref_len=40)
    assert client.sw([ref] * 2, alts) == [sw_align_oracle(ref, a, 0) for a in alts]
    assert server.answered == {OP_SW: 1}
    client.close()


def test_client_fallback_without_server(rng):
    # nothing listens on port 1: the client computes on the device it names
    client = EngineClient("127.0.0.1", 1, device="cpu")
    assert not client.connected and not client.used_fallback
    reads, haps = gen_pairhmm_input(rng, 2, 1, max_read_len=16, max_hap_len=24)
    lik = client.pairhmm(reads, haps)
    assert client.used_fallback
    assert client._local.device.type == "cpu"
    np.testing.assert_allclose(lik, _lik_oracle(reads, haps), rtol=5e-3)
    ref, alts = gen_sw_batch(rng, 2, ref_len=30)
    assert client.sw([ref] * 2, alts) == [sw_align_oracle(ref, a, 0) for a in alts]
    genome = gen_reference_with_repeats(rng, 700)
    client.load_reference(genome)
    reads_s = gen_smem_reads(rng, genome, 2, read_len=50)
    fm = FMIndex.build(genome)
    assert client.smem(reads_s) == [mem_collect_intv_oracle(fm, r) for r in reads_s]


def test_daemon_loads_persisted_index(server, rng, tmp_path):
    genome = gen_reference_with_repeats(rng, 900)
    fm = FMIndex.build(genome)
    prefix = str(tmp_path / "idx")
    save_bwa_index(prefix, fm)
    client = _client(server)
    client.load_reference_path(prefix)
    reads = gen_smem_reads(rng, genome, 2, read_len=60)
    assert client.smem(reads) == [mem_collect_intv_oracle(fm, r) for r in reads]
    # the fallback loads the same prefix locally
    local = EngineClient("127.0.0.1", 1, device="cpu")
    local.load_reference_path(prefix)
    assert local.used_fallback and local.smem(reads) == client.smem(reads)
    client.shutdown_server()


def test_device_trace_writes_a_trace(tmp_path, rng):
    eng = GenomicsEngine(device="cpu")
    reads, haps = gen_pairhmm_input(rng, 2, 2, max_read_len=20, max_hap_len=30)
    with device_trace(str(tmp_path / "trace"), eng.device) as prof:
        eng.pairhmm_matrix_flat(*flat_matrix_args(reads, haps))  # the device route
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert json.load(open(tmp_path / "trace" / files[0]))["traceEvents"]
    assert any(e.key.startswith("aten::") for e in prof.key_averages())


def test_daemon_cli_conf(rng, tmp_path):
    """The daemon from a JSON conf (a persisted index, engine geometry) as
    a subprocess on --device cpu, one round trip, then shutdown."""
    genome = gen_reference_with_repeats(rng, 700)
    fm = FMIndex.build(genome)
    prefix = str(tmp_path / "idx")
    save_bwa_index(prefix, fm)
    conf = dict(host="127.0.0.1", port=0, index_prefix=prefix,
                engine=dict(pairhmm=dict(read_buckets=[32, 64], hap_buckets=[64, 128])))
    cpath = tmp_path / "daemon.json"
    cpath.write_text(json.dumps(conf))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "acc_genomics_tpu_torch.parallel.service",
         "--conf", str(cpath), "--device", "cpu"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, text=True,
    )
    try:
        lines = queue.Queue()  # read in a thread, so a silent daemon cannot hang the test
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                         daemon=True).start()
        first, second = lines.get(timeout=TIMEOUT), lines.get(timeout=TIMEOUT)
        m = re.search(r"listening on ([\d.]+):(\d+) \(device cpu\)", second)
        assert "index loaded" in first and m, (first, second)
        client = EngineClient(m.group(1), int(m.group(2)), timeout=30, device="cpu",
                              request_timeout=TIMEOUT)
        assert client.connected
        reads = gen_smem_reads(rng, genome, 2, read_len=50)
        assert client.smem(reads) == [mem_collect_intv_oracle(fm, r) for r in reads]
        client.shutdown_server()
        assert proc.wait(timeout=60) == 0
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_concurrent_clients(server, rng):
    """Two clients interleave requests against one daemon: the engine lock
    serialises them and every answer stays exact."""
    genome = gen_reference_with_repeats(rng, 1500)
    fm = FMIndex.build(genome)
    warm = _client(server)
    warm.load_reference(genome)
    read_sets = [gen_smem_reads(rng, genome, 3, read_len=48) for _ in range(2)]
    warm.close()
    errs = []

    def client_work(reads):
        try:
            c = _client(server)
            for _ in range(3):
                assert c.smem(reads) == [mem_collect_intv_oracle(fm, r) for r in reads]
            c.close()
        except BaseException as e:
            errs.append(e)

    threads = [threading.Thread(target=client_work, args=(rs,)) for rs in read_sets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * TIMEOUT)
    assert not errs, errs
    assert not any(t.is_alive() for t in threads)
    assert server.answered == {OP_LOAD_REF: 1, OP_SMEM: 6}


def test_jax_client_talks_to_port_daemon(server, rng, tmp_path):
    """The JAX package's client (it only serialises: no JAX compile) against
    the port's daemon: the wire format and opcodes are the same."""
    client = JaxEngineClient(*server.address, timeout=10.0)
    assert client.connected
    client._sock.settimeout(TIMEOUT)
    reads, haps = gen_pairhmm_input(rng, 3, 2, max_read_len=30, max_hap_len=60)
    np.testing.assert_allclose(client.pairhmm(reads, haps), _lik_oracle(reads, haps),
                               rtol=5e-3)
    ref, alts = gen_sw_batch(rng, 3, ref_len=50)
    assert client.sw([ref] * 3, alts, strategy=1) == [sw_align_oracle(ref, a, 1)
                                                      for a in alts]
    genome = gen_reference_with_repeats(rng, 800)
    seeds = _seeds(rng, genome, 4)
    res = client.extend(seeds)
    assert res == [{k: w[k] for k in r} for r, w in zip(res, _extend_oracle(seeds))]
    fm = FMIndex.build(genome)
    client.load_reference(genome)
    smem_reads = gen_smem_reads(rng, genome, 2, read_len=60)
    assert client.smem(smem_reads) == [mem_collect_intv_oracle(fm, r) for r in smem_reads]
    prefix = str(tmp_path / "idx")
    save_bwa_index(prefix, fm)
    client.load_reference_path(prefix)
    assert client.smem(smem_reads) == [mem_collect_intv_oracle(fm, r) for r in smem_reads]
    assert server.answered == {OP_PAIRHMM: 1, OP_SW: 1, OP_EXTEND: 1, OP_LOAD_REF: 2,
                               OP_SMEM: 2}
    client.shutdown_server()
