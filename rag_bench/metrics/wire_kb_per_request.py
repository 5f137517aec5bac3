"""The transcript's total bytes (request, reply, fetch and documents) over
1000, the mean over completed requests."""


def read(run):
    sizes = [run.result[i].transcript.total_bytes for i in run.done
             if run.ok(i)]
    return sum(sizes) / len(sizes) / 1e3 if sizes else None
