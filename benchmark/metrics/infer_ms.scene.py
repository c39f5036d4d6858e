"""Mean wall time of ``infer_canvases`` a scene: padding to the bucket,
upload, encode, head and read-back (benchmark span)."""


def read(run):
    infer = run.counters.get("infer_s")
    return 1e3 * sum(infer) / len(infer) if infer else None
