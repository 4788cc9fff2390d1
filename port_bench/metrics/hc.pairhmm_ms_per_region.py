"""HaplotypeCallerCore's PairHMM phase (``anatomy["pairhmm_s"]``, a host
clock around ``compute_pairs_flat``, which returns numpy) per region."""


def read(rec):
    s = rec["delta"]["anatomy"].get("pairhmm_s")
    if s is None or not rec["items"]:
        return None
    return 1e3 * s / rec["items"]
