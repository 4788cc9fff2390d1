"""Share of the window's read-haplotype pairs whose byte planes the
PairHMM engine built on the card from the uploaded streams
(``anatomy["card_pack_pairs"]``, the change of its ``stats["card_packed"]``
over HaplotypeCallerCore's calls).  A program without the counter reads
None."""


def read(rec):
    n = len(rec["inputs"].get("pairhmm_lens", ()))
    k = rec["delta"]["anatomy"].get("card_pack_pairs")
    if k is None or not n:
        return None
    return 100.0 * k / n
