"""Share of the rows handed to the image encode that are the loader's
padding (the benchmark's wrapper of ``encode_images`` counts them)."""


def read(run):
    rows = sum(run.counters.get("encode_rows", ()))
    if not rows:
        return None
    return 100.0 * (rows - run.counters["valid_images"]) / rows
