"""Device operations launched inside the program's ``rx.scan`` span (the
block scan of ``StreamReceiver.process``) per call, counted per span in the
trace of the traced window and averaged over the spans that lie inside the
harness's ``process`` spans and whose device records the profiler kept."""

from crn_bench.harness import span_ops


def read(rec):
    inside = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in rec["events"]
              if e.get("cat") == "user_annotation" and e["name"] == "process"]

    def kept(e):
        if e.get("cat") != "user_annotation" or e["name"] != "rx.scan":
            return True
        mid = float(e["ts"]) + float(e["dur"]) / 2
        return any(a <= mid <= b for a, b in inside)

    counts = [len(ops) for ops in span_ops(dict(rec, events=[e for e in rec["events"] if kept(e)]), "rx.scan")
              if ops]
    return sum(counts) / len(counts) if counts else None
