"""Share of the traced part's `lrf.encode.init.gram_fetch` spans whose
`ready` attribute is true, in percent: of the batches whose Grams the
encode pipeline fetched a batch ahead (`lrf_tpu_torch/parallel/encode.py`),
those whose copy to the host had ended before the calling thread came to
wait for it. A program that writes no `ready` attribute (one whose fetch
copies and waits in one call) gives nothing to read."""

from portbench.spans import traced


def read(ctx):
    if ctx.kind != "encode":
        return None
    fetches = [s for s in traced(ctx, "lrf.encode.init.gram_fetch") or ()
               if "ready" in (getattr(s, "attrs", None) or {})]
    if not fetches:
        return None
    return 100.0 * sum(bool(s.attrs["ready"]) for s in fetches) / len(fetches)
