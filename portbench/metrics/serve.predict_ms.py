"""Device ms a request under ``models/baseline.py`` ``predict`` (the towers
and ``models/encoder.py``'s blocks)."""

from portbench.bench import readers as RD


def read(run):
    return RD.span_ms(run, "pb.predict")
