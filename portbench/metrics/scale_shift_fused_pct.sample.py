"""The share of the ADM's scale-shift ResBlocks whose ``out_layers`` kernel
K1 serves, %: the program's ``block.scale_shift`` count over
``block.scale_shift`` + ``block.scale_shift_split`` (any other route; a
program with no such counter has none), over the whole run, set-up
included. Read only where K1 launched: on the CPU every call runs the
plain version."""

from portbench.metrics._program import registry


def read(summary):
    prof = registry()
    if prof is None:
        return None
    counts = prof.counts()
    fused = counts.get("block.scale_shift")
    split = counts.get("block.scale_shift_split", 0)
    if fused is None or not fused + split \
            or not counts.get("gn_silu_conv3x3"):
        return None
    return 100.0 * fused / (fused + split)
