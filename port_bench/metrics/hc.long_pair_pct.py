"""Share of the window's read-haplotype pairs whose read is longer than
the default read buckets take (255 bases) and that HaplotypeCallerCore
scored on the device route (``anatomy["long_pairs"]``).  A program
without the counter reads None."""


def read(rec):
    n = len(rec["inputs"].get("pairhmm_lens", ()))
    k = rec["delta"]["anatomy"].get("long_pairs")
    if k is None or not n:
        return None
    return 100.0 * k / n
