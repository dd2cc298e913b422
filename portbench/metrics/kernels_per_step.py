"""Device launches (kernels, copies and sets) a step, from the traced
steps."""


def read(summary):
    tr = summary.get("trace")
    if not tr or not tr["launches"]:
        return None
    return tr["launches"] / tr["steps"]
