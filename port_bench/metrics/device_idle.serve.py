"""Share of the profiled window in which no operation ran on the device."""

from port_bench.harness.common import idle_share as read  # noqa: F401
