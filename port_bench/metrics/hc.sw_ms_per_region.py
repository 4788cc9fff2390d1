"""HaplotypeCallerCore's SW phase (``anatomy["sw_s"]``, a host clock
around ``sw.align``, which returns decoded CIGARs) per region."""


def read(rec):
    s = rec["delta"]["anatomy"].get("sw_s")
    if s is None or not rec["items"]:
        return None
    return 1e3 * s / rec["items"]
