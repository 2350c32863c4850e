"""Per cent of the channel-nodes the traced stretch's walks stepped over
that belong to a labelled class's own (eh, ew) window (the refiner's
counters ``labelled_nodes`` over ``walked_nodes``, read as differences
around the stretch): the rest is the walk's padding of classes and
canvas."""


def read(ctx):
    counts = getattr(ctx["driver"], "counts", None)
    if not counts or counts["walked_nodes"] <= 0:
        return None
    return 100.0 * counts["labelled_nodes"] / counts["walked_nodes"]
