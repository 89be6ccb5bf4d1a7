"""Mean ms of ServingEngine.localize_features (match and localize) over
the traced run's split requests: CUDA events recorded on the device's
stream around the call, read as device time."""


def read(ctx):
    v = ctx["spans"].get("localize")
    return sum(v) / len(v) if v else None
