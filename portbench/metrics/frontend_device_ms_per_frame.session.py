"""Device ms of the frontend a drone frame in the traced session chunks:
for each frame step, the union of the device's intervals from the step's
image copy-in to the start of its B1 launch (k2nn_mma_kernel), summed
over the steps and divided by the traced drone frames.

Inside a graph replay no host code runs, so the frame step is found by
order in the device trace, and the reader relies on the copy order of
coloc_tpu_torch.session._StepGraphs.replay: it copies the step's images
and then its draws into the static buffers (two device-to-device copies,
back to back) and launches the head graph, whose first kernels are the
frontend's and whose first B1 follows them; the frontend itself makes no
copy (memsets only; checked on a traced chunk on the H100). So a step's
draws copy is the last device-to-device copy before its B1, and its
image copy-in the event just before that. Each step opens one
`coloc.session.step` span on the host, and every step launches B1 once:
nothing is returned unless the trace holds as many B1 launches as step
spans, these divide the traced drone frames, and each step has both
markers."""

from portbench import roofline, spans, trace


def _copy(e) -> bool:
    return e.name.startswith("Memcpy DtoD")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["frames"]:
        return None
    dev = tr.device
    b1 = [j for j, e in enumerate(dev) if roofline.kernel_of(e.name) == "k2nn"]
    steps = len(spans.named(tr, spans.STEP))
    if not b1 or len(b1) != steps or ctx["frames"] % steps:
        return None
    total, prev = 0, -1
    for j in b1:
        copies = [i for i in range(prev + 1, j) if _copy(dev[i])]
        if not copies or copies[-1] < 1 or not _copy(dev[copies[-1] - 1]):
            return None
        a, b = dev[copies[-1] - 1].start_ns, dev[j].start_ns
        clipped = [e._replace(start_ns=max(e.start_ns, a), end_ns=min(e.end_ns, b))
                   for e in dev[prev + 1:j] if e.end_ns > a and e.start_ns < b]
        total += sum(y - x for x, y in trace.busy_intervals(clipped))
        prev = j
    return total / ctx["frames"] / 1e6
