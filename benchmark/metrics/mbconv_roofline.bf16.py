"""Per cent of its roofline that the bf16 MBConv kernel reaches in the
traced stretch of a bfloat16 serving cell: the least time of the
stretch's MBConv work at bfloat16 (``counts/mbconv_bf16.py``) over the
device time of the MBConv library's kernels in the trace.  Nothing to
read where no such kernel ran."""

from benchmark.counts.mbconv_bf16 import batch_least_seconds

KERNELS = r"::(expand_dw|se_squeeze|se|project|project_bf16)_kernel\b"


def read(ctx):
    s = ctx["trace"]
    if s is None or not hasattr(ctx["driver"], "stretch_sizes"):
        return None
    device_s = s.seconds_matching(KERNELS)
    if device_s <= 0:
        return None
    scales = ctx["traffic"]["engine"]["scales"]
    least = sum(batch_least_seconds(ctx["config"], scales, sizes)
                for sizes in ctx["driver"].stretch_sizes())
    return 100.0 * least / device_s
