"""Mean ms of the batched frontend (detect_and_describe_batch) over the
traced run's split requests: CUDA events recorded on the device's stream
around the call, read as device time."""


def read(ctx):
    v = ctx["spans"].get("frontend")
    return sum(v) / len(v) if v else None
