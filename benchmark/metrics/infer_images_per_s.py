"""Images whose records came back from ``run_stream`` in the window, over
the window's seconds (host clock, first batch fed to last record back)."""


def read(ctx):
    w = ctx["window"]
    if "images_by_size" not in w:
        return None
    return w["images"] / w["seconds"]
