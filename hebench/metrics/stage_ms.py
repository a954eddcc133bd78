"""``stage_ms.<stage>``: the device-side span of one call a request makes,
between CUDA events on either side of it, mean over the window's
requests (app layer and evaluator). A later cell of a kind that already
has a stage metric names its own ``stage_ms.<stage>.<anything>``: the
part before the second dot is the stage read."""


def read(r: dict, part):
    return r["stage_ms"].get(part.split(".")[0])
