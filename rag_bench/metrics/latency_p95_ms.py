"""95th percentile over every request due in the window, from its
scheduled send time to its result; a failed request counts as missing
every limit."""

from rag_bench.stats import percentile


def read(run):
    return percentile(run.latencies_ms(), 95)
