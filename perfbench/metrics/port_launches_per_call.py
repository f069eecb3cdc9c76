"""Kernels a call launched under the program's spans, counted as
``launches_per_call`` counts (kernels only), over the matched calls
(:mod:`perfbench.spans`).  Notes: kernels, copies and sets a call by the
innermost span that launched them, the harness's apart."""

from perfbench import spans


def read(run):
    r = spans.reading(run)
    if r is None:
        return None
    if not r.sound:
        return r.unsound()
    return {"value": r.count(lambda o: o.kind == "kernel" and o.stack),
            "unmatched_calls": r.unmatched,
            **{f"{plural}_by_span": r.count_by_owner(lambda o, k=kind: o.kind == k)
               for kind, plural in (("kernel", "kernels"), ("copy", "copies"),
                                    ("set", "sets"))}}
