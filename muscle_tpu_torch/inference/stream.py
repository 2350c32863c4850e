"""The serving engines' overlapped stream (``CamTTAEngine.run_stream``,
``SegTTAEngine.run_stream``): three stages at once, each named by its
thread and its span (``utils/timers.py``):

* ``prep`` on the thread "prep": a fed batch's share under the mesh and
  its host prep (canvas packing), up to ``prep_ahead`` batches ahead;
* ``dispatch`` on the caller's thread: the upload, the device pipeline's
  enqueue and the download's start; the thread waits in ``wait_prep`` for
  the next prepped batch and in ``wait_result`` for the oldest batch's
  records;
* ``finalize`` on the thread "finalize_0": the blocking wait for the
  download (``fetch``) and the host's work on it, up to
  ``finalize_ahead`` batches behind the dispatch.

Results come back in the order fed; an error of the prep thread is
raised on the caller's.  Under a mesh the records are gathered on the
caller's thread, which issues every collective in the same order on
every rank.  ``batch`` is a span's sequence number in the stream,
``images`` the images of this rank's share."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

from muscle_tpu_torch.parallel.mesh import gather_rows
from muscle_tpu_torch.utils.timers import span


def _spanned(finalize, k: int, images: int):
    def run() -> list:
        with span("finalize", batch=k, images=images):
            return finalize()

    return run


def run_stream(batches, prepare, dispatch, mesh, prep_ahead: int, finalize_ahead: int):
    """Yield each batch's records, in order.  ``prepare(batch) -> (prep,
    gather)``: this rank's host prep of a fed batch (a dict with its
    ``names``) and whether the ranks' records are gathered;
    ``dispatch(prep) -> finalize``: enqueues it on the device and returns
    the closure that waits for its records."""
    prep_q: queue.Queue = queue.Queue(maxsize=max(1, prep_ahead))
    sentinel = object()

    def produce():
        try:
            for k, batch in enumerate(batches):
                with span("prep", batch=k) as s:
                    prep, gather = prepare(tuple(batch))
                    s.set(images=len(prep["names"]))
                prep_q.put((k, prep, gather))
        except BaseException as e:  # re-raised in the consumer
            prep_q.put(e)
            return
        prep_q.put(sentinel)

    def records(fut, gather) -> list:
        with span("wait_result"):
            recs = fut.result()
        return gather_rows(recs, mesh.data_group) if gather else recs

    threading.Thread(target=produce, name="prep", daemon=True).start()
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="finalize") as fin_ex:
        pending: list = []
        while True:
            with span("wait_prep"):
                item = prep_q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            k, prep, gather = item
            n = len(prep["names"])
            with span("dispatch", batch=k, images=n):
                finalize = dispatch(prep)
            pending.append((fin_ex.submit(_spanned(finalize, k, n)), gather))
            if len(pending) > finalize_ahead:
                yield records(*pending.pop(0))
        for fut, gather in pending:
            yield records(fut, gather)
