"""BWA-MEM seeding and seed extension through the port's device pipeline.

One call maps the mix's ``reads_per_call`` reads, cycling through a pool
of ``pool_calls`` batches drawn from the run's seed:
``BwaMemDevicePipeline.map_reads_arrays`` (SMEM intervals on the card,
seed enumeration, one fused extension launch), then, for the reads it
hands back in ``host_read_idx``, ``BwaMemSeeding.map_reads`` as the
pipeline's own ``map_reads`` runs them.  So every read is mapped.

The genome comes from the configuration's seed.  The port's FM-index is
built by ``FMIndex.build`` once per checkout and kept under
``port_bench/.cache/``; so is the suffix array the reference builds for
itself.  The check recomputes a sample of the window's reads, drawn from
the seed (host-routed reads among them where there are any), with the
plain references: SMEM intervals, seeds (query start, length,
occurrences, text position) and both extensions, all exactly.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from port_bench.gen.genome import make_genome
from port_bench.gen.reads import make_reads
from port_bench.kinds import common
from port_bench.reference import extend as ref_extend
from port_bench.reference import fm as ref_fm

_HERE = os.path.dirname(os.path.abspath(__file__))


def _genome_key(cfg: dict) -> str:
    return json.dumps(cfg["genome"], sort_keys=True)


class Cell:
    items = "reads"

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str, cache_dir: str):
        import acc_genomics_tpu_torch.ops.smem.index as port_index
        from acc_genomics_tpu_torch.config import engine_config_from_dict
        from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine
        from acc_genomics_tpu_torch.models.bwa_mem import BwaMemDevicePipeline, BwaMemSeeding
        from acc_genomics_tpu_torch.ops.smem.index import FMIndex

        self.cfg, self.mix, self.device, self.cache_dir = cfg, mix, device, cache_dir
        e = cfg["engine"]["extend"]
        self.ext_params = ref_extend.ExtendParams(
            o_del=e["o_del"], e_del=e["e_del"], o_ins=e["o_ins"], e_ins=e["e_ins"],
            pen_clip=e["pen_clip"], w=e["w"], sc_match=e["match"],
            sc_mismatch=e["mismatch"], sc_ambig=e["ambig"])
        self.genome, self.copies = make_genome(cfg["genome"])
        key = common.file_hash([port_index.__file__, os.path.join(_HERE, "..", "gen", "genome.py")],
                               _genome_key(cfg))
        path = os.path.join(cache_dir, f"fmindex-{key}.npz")
        self.index_built_s = None
        if os.path.exists(path):
            fm = FMIndex.load(path)
        else:
            t0 = time.perf_counter()
            fm = FMIndex.build(self.genome)
            self.index_built_s = time.perf_counter() - t0
            tmp = os.path.join(cache_dir, f"fmindex-{key}.tmp.npz")
            fm.save(tmp)
            os.replace(tmp, path)
            print(f"FMIndex.build {self.index_built_s:.1f} s; {path} "
                  f"{os.path.getsize(path)} bytes", file=sys.stderr)
        self.index_path = path
        self.engine = GenomicsEngine(engine_config_from_dict(cfg.get("engine", {})), device)
        self.engine.set_index(fm)
        b = cfg["bwa"]
        self.pipe = BwaMemDevicePipeline(self.engine, int(b["max_occ"]), int(b["flank"]))
        self.seeding = BwaMemSeeding(self.engine, int(b["max_occ"]), int(b["flank"]))
        rng = np.random.default_rng(common.seed_words(seed))
        self.seed = seed
        self.per_call = int(mix["reads_per_call"])
        self.pool_calls = int(mix["pool_calls"])
        reads = make_reads(rng, self.genome, self.copies, mix, self.per_call * self.pool_calls)
        self.batches = [list(reads[c * self.per_call:(c + 1) * self.per_call])
                        for c in range(self.pool_calls)]
        self.outputs = {}  # call -> (seeds, host reads, {read: answer} of its candidates)

    def batch_of(self, k: int):
        return self.batches[k % self.pool_calls]

    def call(self, k: int) -> int:
        reads = self.batch_of(k)
        hits, rid, meta, host_idx = self.pipe.map_reads_arrays(reads)
        order = sorted(set(host_idx))
        host = self.seeding.map_reads([reads[i] for i in order]) if order else []
        self.outputs[k] = self.keep(k, hits, rid, meta, order, host)
        return len(reads)

    def keep(self, k, hits, rid, meta, order, host):
        """The answers of the call's candidates for the check, drawn from
        the seed: ``check_reads`` reads, and ``check_host_reads`` of the
        host-routed ones; the device route's as (seeds, hits) tuples, the
        host route's as ``SeedHit`` tuples."""
        rng = np.random.default_rng(common.seed_words(self.seed, 2, k))
        n = len(self.batch_of(k))
        routed = dict(zip(order, host))
        qbeg, slen, occ = meta
        kept = {}
        for i in rng.choice(n, min(int(self.mix["check_reads"]), n), replace=False).tolist():
            if i in routed:
                continue
            lo, hi = np.searchsorted(rid, [i, i + 1])
            kept[i] = ("device",
                       list(zip(qbeg[lo:hi].tolist(), slen[lo:hi].tolist(),
                                occ[lo:hi].tolist(), hits[7, lo:hi].tolist())),
                       [tuple(c) for c in hits[:, lo:hi].T.tolist()])
        nh = min(int(self.mix["check_host_reads"]), len(order))
        for i in (rng.choice(order, nh, replace=False).tolist() if nh else []):
            kept[i] = ("host", [(h.qbeg, h.qend, h.rbeg, h.rend, h.score, h.true_score,
                                 h.width, h.occ) for h in routed[i]])
        return int(hits.shape[1]), len(order), kept

    def warm(self, calls: int) -> None:
        for k in range(calls):
            self.call(k)
        self.outputs.clear()
        self.pipe.reset_anatomy()

    def layer_spans(self):
        return [(self.engine.smem, "collect_arrays", "bwa.smem"),
                (self.pipe, "map_reads_arrays", "bwa.pipeline"),
                (self.seeding, "map_reads", "bwa.host_route")]

    def snapshot(self) -> dict:
        return dict(common.program_counters(), anatomy=dict(self.pipe.anatomy))

    def window_inputs(self, calls) -> dict:
        host = sum(self.outputs[k][1] for k in calls if k in self.outputs)
        return dict(bwa_reads=self.per_call * len(calls), bwa_host_reads=host)

    def free_program(self) -> None:
        del self.engine, self.pipe, self.seeding
        common.free_device()

    # -- the check --------------------------------------------------------

    def reference_index(self) -> ref_fm.RefIndex:
        key = common.file_hash([ref_fm.__file__, os.path.join(_HERE, "..", "gen", "genome.py")],
                               _genome_key(self.cfg))
        path = os.path.join(self.cache_dir, f"ref_sa-{key}.npy")
        if os.path.exists(path):
            return ref_fm.RefIndex.build(self.genome, np.load(path).astype(np.int64))
        t0 = time.perf_counter()
        idx = ref_fm.RefIndex.build(self.genome)
        tmp = os.path.join(self.cache_dir, f"ref_sa-{key}.tmp.npy")
        np.save(tmp, idx.sa[1:].astype(np.int32))
        os.replace(tmp, path)
        print(f"reference index {time.perf_counter() - t0:.1f} s; {path} "
              f"{os.path.getsize(path)} bytes", file=sys.stderr)
        return idx

    def sample(self, calls: int, seed: int):
        """(device-route picks, host-route picks) [(call, read)] drawn
        from the seed among the window's kept candidates."""
        rng = np.random.default_rng(common.seed_words(seed, 1))
        cands = [(k, i, v[0]) for k in range(calls) if k in self.outputs
                 for i, v in sorted(self.outputs[k][2].items())]
        out = []
        for route, n in (("device", "check_reads"), ("host", "check_host_reads")):
            c = [(k, i) for k, i, r in cands if r == route]
            pick = rng.choice(len(c), min(int(self.mix[n]), len(c)), replace=False)
            out.append([c[t] for t in sorted(pick.tolist())])
        return out

    def expected(self, idx: ref_fm.RefIndex, read: np.ndarray, params) -> list:
        """Per seed (qbeg, slen, occ, pos) and the extension's eight values
        [qBeg, qEnd, rBeg, rEnd, score, trueScore, width, pos]."""
        b = self.cfg["bwa"]
        max_occ, flank = int(b["max_occ"]), int(b["flank"])
        out = []
        for iv in ref_fm.mem_collect_intv(idx, read, params):
            slen = iv["end"] - iv["start"]
            for row in range(iv["x0"], iv["x0"] + min(iv["s"], max_occ)):
                pos = int(idx.sa[row])
                lo = max(0, pos - iv["start"] - flank)
                hi = min(idx.seq_len, pos + slen + (len(read) - iv["end"]) + flank)
                e = ref_extend.extend_seed_oracle(read, idx.text[lo:hi], iv["start"],
                                                  pos - lo, slen, self.ext_params)
                out.append(dict(seed=(iv["start"], slen, iv["s"], pos),
                                hit=(e["qBeg"], e["qEnd"], e["rBeg"], e["rEnd"], e["score"],
                                     e["trueScore"], e["width"], pos)))
        return out

    def check(self, calls: int, seed: int, ref_device: str, control: bool = False):
        idx = self.reference_index()
        full = ref_fm.SmemParams(**{k: self.cfg["engine"]["smem"][k]
                                    for k in ref_fm.SmemParams._fields})
        # the control: the reference with the re-seed and third passes off
        broken = full._replace(split_len=1 << 30, max_mem_intv=0)
        dev, host = self.sample(calls, seed)
        seed_bad = hit_bad = host_bad = 0
        for k, i in dev:
            read = self.batch_of(k)[i]
            want = self.expected(idx, read, full)
            if control:
                got = self.expected(idx, read, broken)
                got_seeds = [g["seed"] for g in got]
                got_hits = [g["hit"] for g in got]
            else:
                _, got_seeds, got_hits = self.outputs[k][2][i]
            seed_bad += int(got_seeds != [w["seed"] for w in want])
            hit_bad += int(got_hits != [w["hit"] for w in want])
        for k, i in host:
            read = self.batch_of(k)[i]
            want = [_seedhit(w) for w in self.expected(idx, read, full)]
            host_bad += int(self.outputs[k][2][i][1] != want)
        nums = [("seed_mismatch_reads", seed_bad, 0), ("hit_mismatch_reads", hit_bad, 0),
                ("host_read_mismatches", host_bad, 0)]
        return nums


def _seedhit(w):
    """A reference seed in ``SeedHit`` terms (absolute query end and text
    coordinates)."""
    qb, slen, occ, pos = w["seed"]
    q0, qe, rb, re_, score, ts, width, _ = w["hit"]
    return (q0, qb + slen + qe, pos + rb, pos + slen + re_, score, ts, width, occ)
