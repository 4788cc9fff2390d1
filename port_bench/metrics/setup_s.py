"""Process start to the first timed call: inputs, index load or build,
the program's set-up and the warm-up calls (host clock)."""


def read(rec):
    return rec["setup_s"]
