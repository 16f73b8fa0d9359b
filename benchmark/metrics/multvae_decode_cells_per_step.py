"""Logits a Mult-VAE training step's softmax covers (program_counter):
the program's ``decode_cells`` counter (B x I, the batch's users by the
whole catalog) over its count of ``multvae.step`` spans. Both tally only
while a profiler runs: the traced stretch's steps. It guards that the
loss stays over the whole catalog (about 500 x 17,769 = 8,884,500 at
Netflix's size, less in an epoch's last, smaller batch). None where the
program has no such counter, or where no work ran on the device."""


def read(t):
    if t.kind != "train" or t.trace.busy_s <= 0:
        return None
    try:
        from cdae_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    tl = tallies()
    steps, _ = tl.spans.get("multvae.step", (0, 0.0))
    cells = tl.counters.get("decode_cells")
    return cells / steps if steps and cells is not None else None
