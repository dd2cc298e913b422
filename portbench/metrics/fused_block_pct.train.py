"""The share of the UNet's Block calls that kernel K1 serves, %: the
program's ``block.fused`` count over ``block.fused`` + ``block.split``
(GroupNorm, dropout and a plain conv), over the whole run, set-up
included. Read only where K1 launched: on the CPU every Block runs the
plain version."""

from portbench.metrics._program import registry

K1 = ("gn_silu_conv3x3", "gn_silu_conv3x3_halo")


def read(summary):
    prof = registry()
    if prof is None:
        return None
    counts = prof.counts()
    fused, split = counts.get("block.fused"), counts.get("block.split")
    if fused is None or split is None or not fused + split \
            or not sum(counts.get(k, 0) for k in K1):
        return None
    return 100.0 * fused / (fused + split)
