"""Share of the traced window, in %, in which no kernel, copy or set ran
on the card: 1 - (union of the device intervals) / window."""


def read(r):
    if not r["busy_s"]:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
