"""The share of the traced window in which no device activity ran, %."""


def read(summary):
    tr = summary.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
