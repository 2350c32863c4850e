"""Host ms an image of the refinement stream's prep stage in the traced
stretch: the spans ``prep`` (each batch's bucketing and packing, the
CAMs' downscale ``cam_pack`` inside) over the stretch's images."""


def read(ctx):
    spans = getattr(ctx["driver"], "spans", None)
    s = ctx["trace"]
    if not spans or s is None or s.units <= 0:
        return None
    ns = sum(r.end_ns - r.start_ns for r in spans if r.name == "prep")
    return ns / 1e6 / s.units if ns > 0 else None
