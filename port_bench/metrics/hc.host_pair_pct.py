"""Share of the window's read-haplotype pairs that HaplotypeCallerCore
scored on the native host forward (``anatomy["host_pairs"]``, the
PairHMM engine's host fallbacks over its calls).  A program without the
counter reads None."""


def read(rec):
    n = len(rec["inputs"].get("pairhmm_lens", ()))
    k = rec["delta"]["anatomy"].get("host_pairs")
    if k is None or not n:
        return None
    return 100.0 * k / n
