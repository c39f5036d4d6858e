"""Kernel launches a bigE block: the window's launches of the kernels (the
program's counter ``launches``, by name; a mode's and an entry's counters
left out, as each launch also counts under its kernel's name) over the
tower's 64 layers times the encodes handed to it (program counter)."""

WRAPPERS = ("fused_",)  # entries whose calls run kernels counted apart


def read(run):
    launches, rows = run.counters.get("launches"), run.counters.get("encode_rows")
    if not launches or not rows:
        return None
    kernels = sum(n for name, n in launches.items()
                  if "." not in name and not name.startswith(WRAPPERS))
    return kernels / (run.config["vision_layers"] * len(rows))
