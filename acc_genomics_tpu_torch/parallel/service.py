"""Engine service: client/daemon offload over TCP.

The port of ``acc_genomics_tpu/parallel/service.py`` onto the port's
``GenomicsEngine``, the counterpart of the reference's Blaze layer
(pairhmm/client/* + pairhmm/task/*): an application process sends
batches to a daemon that owns the card and keeps the FM-index resident
across requests; a client that reaches no daemon computes with a local
engine on the device its caller names and sets ``used_fallback``
(PairHMMClient::compute, pairhmm/client/PairHMMClient.cpp:69-85).

Wire format, the JAX service's, so either package's client talks to
either package's daemon: one frame per message,
    u32 opcode | u64 payload length | payload
with the payload an npz archive of named numpy arrays (allow_pickle=False
both ways; no code crosses the wire).  An engine error comes back as a
frame of opcode 0 holding ``error``, and the client raises it.

Run the daemon with ``python -m acc_genomics_tpu_torch.parallel.service
[--conf daemon.json] [--host H] [--port P] [--device cuda]``.
"""

from __future__ import annotations

import collections
import io
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional

import numpy as np

OP_PAIRHMM = 1
OP_SMEM = 2
OP_SW = 3
OP_LOAD_REF = 4
OP_EXTEND = 5
OP_SHUTDOWN = 99

_EXTEND_FIELDS = ("qBeg", "qEnd", "rBeg", "rEnd", "score", "trueScore", "width")

_HDR = struct.Struct("<IQ")


def _pack(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _unpack(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _send(sock: socket.socket, op: int, arrays: Dict[str, np.ndarray]):
    payload = _pack(arrays)
    sock.sendall(_HDR.pack(op, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], min(1 << 20, n - got))
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return bytes(buf)


def _recv(sock: socket.socket):
    op, ln = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return op, _unpack(_recv_exact(sock, ln))


def _encode_ragged(arrs: List[np.ndarray], dtype=np.uint8):
    lens = np.array([len(a) for a in arrs], np.int64)
    flat = (
        np.concatenate([np.asarray(a, dtype) for a in arrs])
        if arrs
        else np.zeros(0, dtype)
    )
    return flat, lens


def _decode_ragged(flat: np.ndarray, lens: np.ndarray) -> List[np.ndarray]:
    ends = np.cumsum(lens)
    return [flat[e - ln: e] for e, ln in zip(ends.tolist(), lens.tolist())]


class EngineServer:
    """Daemon owning one GenomicsEngine (and so the card).

    ``engine``: a built engine to serve, else ``GenomicsEngine(device=
    device)``.  ``answered`` counts the requests answered without an
    error, by opcode."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, engine=None,
                 device="cuda"):
        if engine is None:
            from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine

            engine = GenomicsEngine(device=device)
        self.engine = engine
        self.answered: collections.Counter = collections.Counter()
        # one engine, many client threads: requests run one at a time,
        # as the Blaze daemon runs one task at a time an accelerator
        # (pairhmm/task/xlnx/PairHMMTask.cpp); the engines' stats, streams
        # and index are not thread-safe
        self._engine_lock = threading.Lock()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        op, req = _recv(self.request)
                    except ConnectionError:
                        return
                    if op == OP_SHUTDOWN:
                        _send(self.request, op, {})
                        outer._server.shutdown()
                        return
                    try:
                        with outer._engine_lock:
                            resp = outer._dispatch(op, req)
                            outer.answered[op] += 1
                        _send(self.request, op, resp)
                    except Exception as e:  # report, keep serving
                        _send(
                            self.request, 0,
                            {"error": np.frombuffer(str(e).encode(), np.uint8)},
                        )

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def _dispatch(self, op: int, req: Dict[str, np.ndarray]):
        if op == OP_LOAD_REF:
            if "prefix" in req:
                # a persisted BWA-format index on the daemon's disk: big
                # read-only state stays with the card's owner
                from acc_genomics_tpu_torch.io.bwa_index import load_bwa_index

                fm, _ = load_bwa_index(req["prefix"].tobytes().decode())
                self.engine.set_index(fm)
            else:
                self.engine.load_reference(req["genome"])
            return {"ok": np.array([1])}
        if op == OP_PAIRHMM:
            # the wire format is the flat ingestion format
            lik = self.engine.pairhmm.compute_matrix_flat(
                req["rs"], req["q"], req["i"], req["d"], req["c"],
                req["read_lens"].astype(np.int32),
                req["haps"], req["hap_lens"].astype(np.int32),
            )
            return {"lik": lik}
        if op == OP_SMEM:
            flat, counts = self.engine.smem.collect_flat(
                _decode_ragged(req["reads"], req["read_lens"]))
            return {"counts": counts, "intervals": flat}
        if op == OP_SW:
            refs = _decode_ragged(req["refs"], req["ref_lens"])
            alts = _decode_ragged(req["alts"], req["alt_lens"])
            aligned = self.engine.sw.align(refs, alts, int(req["strategy"][0]))
            counts = np.fromiter((len(cig) for cig, _ in aligned), np.int64, len(aligned))
            elems = np.array(
                [e for cig, _ in aligned for e in cig], np.int64
            ).reshape(-1, 2)
            offsets = np.fromiter((off for _, off in aligned), np.int64, len(aligned))
            return {"counts": counts, "elems": elems, "offsets": offsets}
        if op == OP_EXTEND:
            reads = _decode_ragged(req["reads"], req["read_lens"])
            rseqs = _decode_ragged(req["rseqs"], req["rseq_lens"])
            seeds = [
                dict(read=r, rseq=t, qbeg=qb, rbeg_off=ro, len=sl)
                for r, t, qb, ro, sl in zip(
                    reads, rseqs, req["qbeg"].tolist(), req["rbeg_off"].tolist(),
                    req["seed_len"].tolist())
            ]
            res = self.engine.extend_seeds(seeds)
            return {
                k: np.fromiter((r[k] for r in res), np.int64, len(res))
                for k in _EXTEND_FIELDS
            }
        raise ValueError(f"unknown op {op}")

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
            self._thread = None
        self._server.server_close()


class EngineClient:
    """Connects to a daemon; with none reachable, computes with a local
    ``GenomicsEngine(device=device)`` and sets ``used_fallback``.

    ``timeout`` bounds the connect; ``request_timeout`` each request's
    send and receive (None: no bound)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, timeout: float = 5.0,
                 device="cuda", request_timeout: Optional[float] = None):
        self.device = device
        self._sock: Optional[socket.socket] = None
        self._local = None
        self.used_fallback = False
        try:
            self._sock = socket.create_connection((host, port), timeout=timeout)
            self._sock.settimeout(request_timeout)
        except OSError:
            self._sock = None

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _local_engine(self):
        self.used_fallback = True
        if self._local is None:
            from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine

            self._local = GenomicsEngine(device=self.device)
        return self._local

    def _call(self, op: int, req: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        _send(self._sock, op, req)
        _, resp = _recv(self._sock)
        if "error" in resp:  # the daemon's engine raised
            raise RuntimeError(resp["error"].tobytes().decode())
        return resp

    def pairhmm(self, reads, haps) -> np.ndarray:
        if self._sock is None:
            return self._local_engine().pairhmm_matrix(reads, haps)
        req = {}
        for k in ("rs", "q", "i", "d", "c"):
            req[k], req["read_lens"] = _encode_ragged([r[k] for r in reads])
        req["haps"], req["hap_lens"] = _encode_ragged(list(haps))
        return self._call(OP_PAIRHMM, req)["lik"]

    def load_reference(self, genome: np.ndarray):
        if self._sock is None:
            self._local_engine().load_reference(genome)
            return
        self._call(OP_LOAD_REF, {"genome": np.asarray(genome, np.uint8)})

    def load_reference_path(self, prefix: str):
        """Point the daemon at a persisted BWA-format index on its disk."""
        if self._sock is None:
            from acc_genomics_tpu_torch.io.bwa_index import load_bwa_index

            fm, _ = load_bwa_index(prefix)
            self._local_engine().set_index(fm)
            return
        self._call(OP_LOAD_REF, {"prefix": np.frombuffer(prefix.encode(), np.uint8)})

    def smem(self, reads) -> List[List[dict]]:
        if self._sock is None:
            return self._local_engine().smem_collect(list(reads))
        flat, lens = _encode_ragged(list(reads))
        resp = self._call(OP_SMEM, {"reads": flat, "read_lens": lens})
        from acc_genomics_tpu_torch.engine.smem_engine import split_dicts

        return split_dicts(resp["intervals"], resp["counts"])

    def sw(self, refs, alts, strategy: int = 0):
        """Batch SW alignment -> [(cigar, offset)] (FalconSW over the wire)."""
        if self._sock is None:
            return self._local_engine().sw.align(list(refs), list(alts), strategy)
        req = {}
        req["refs"], req["ref_lens"] = _encode_ragged(list(refs))
        req["alts"], req["alt_lens"] = _encode_ragged(list(alts))
        req["strategy"] = np.array([strategy], np.int64)
        resp = self._call(OP_SW, req)
        elems = list(map(tuple, resp["elems"].tolist()))
        ends = np.cumsum(resp["counts"]).tolist()
        return [
            (elems[e - n: e], off)
            for e, n, off in zip(ends, resp["counts"].tolist(), resp["offsets"].tolist())
        ]

    def extend(self, seeds):
        """Batch seed extension -> resolved alignment records."""
        if self._sock is None:
            return self._local_engine().extend_seeds(list(seeds))
        req = {}
        req["reads"], req["read_lens"] = _encode_ragged([s["read"] for s in seeds])
        req["rseqs"], req["rseq_lens"] = _encode_ragged([s["rseq"] for s in seeds])
        req["qbeg"] = np.array([s["qbeg"] for s in seeds], np.int64)
        req["rbeg_off"] = np.array([s["rbeg_off"] for s in seeds], np.int64)
        req["seed_len"] = np.array([s["len"] for s in seeds], np.int64)
        resp = self._call(OP_EXTEND, req)
        cols = [resp[k].tolist() for k in _EXTEND_FIELDS]
        return [dict(zip(_EXTEND_FIELDS, row)) for row in zip(*cols)]

    def shutdown_server(self):
        if self._sock is not None:
            _send(self._sock, OP_SHUTDOWN, {})
            _recv(self._sock)
            self.close()

    def close(self):
        if self._sock is not None:
            self._sock.close()
            self._sock = None


def main(argv=None) -> int:
    """Daemon entry point: ``python -m acc_genomics_tpu_torch.parallel.service``.

    The counterpart of the reference's Blaze daemon started from a
    protobuf conf (pairhmm/xlnx.conf): a JSON config names the bind
    address (``host``, ``port``), the engine geometry (``engine``, as
    ``config.engine_config_from_dict`` reads it) and an optional persisted
    index to load first (``index_prefix``).  ``--host``/``--port`` override
    the config; ``--device`` names the engine's device."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description="acc_genomics_tpu_torch engine daemon")
    ap.add_argument("--conf", help="JSON daemon config file")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="the engine's device (cuda, cuda:N, cpu)")
    args = ap.parse_args(argv)

    from acc_genomics_tpu_torch.config import EngineConfig, engine_config_from_dict
    from acc_genomics_tpu_torch.engine.genomics_engine import GenomicsEngine

    host, port, index_prefix, engine_conf = "127.0.0.1", 0, None, None
    if args.conf:
        with open(args.conf) as f:
            raw = json.load(f)
        host = raw.pop("host", host)
        port = raw.pop("port", port)
        index_prefix = raw.pop("index_prefix", None)
        engine_conf = raw.pop("engine", None)
        if raw:
            raise ValueError(f"unknown daemon config keys: {sorted(raw)}")
    if args.host is not None:
        host = args.host
    if args.port is not None:
        port = args.port

    config = engine_config_from_dict(engine_conf) if engine_conf is not None else EngineConfig()
    server = EngineServer(host=host, port=port,
                          engine=GenomicsEngine(config, device=args.device))
    if index_prefix:
        from acc_genomics_tpu_torch.io.bwa_index import load_bwa_index

        fm, _ = load_bwa_index(index_prefix)
        server.engine.set_index(fm)
        print(f"index loaded from {index_prefix} ({fm.seq_len // 2} bases)")
    print(f"engine daemon listening on {server.address[0]}:{server.address[1]} "
          f"(device {server.engine.device})", flush=True)
    try:
        server._server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server._server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
