"""Host reads of the pose LM's exit a serving request: the number of
`coloc.lm.exit_read` spans over the number of `coloc.serve.request`
spans in the traced requests (the host-sync counter)."""

from portbench import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    requests = spans.named(tr, spans.REQUEST)
    if not requests:
        return None
    return len(spans.named(tr, spans.EXIT_READ)) / len(requests)
