"""Share of the window in which the card ran no operation (device trace)."""

from benchmark.readers import idle_share as read  # noqa: F401
