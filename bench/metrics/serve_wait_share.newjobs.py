"""serve_wait_share.newjobs: the share of the advisor's answer time that
requests spend waiting for the session (`serve/server.py`): the program's
``serve.wait`` spans over its ``serve.request`` spans, both summed over
the requests whose ``serve.request`` starts inside the window. A wait is
matched to its request by the spans' ``req``."""


def read(info):
    total = {}
    for s in info.program_spans:
        if s.name == "serve.request" and s.start >= 0.0:
            total[dict(s.meta).get("req")] = s.dur
    if not total or sum(total.values()) <= 0.0:
        return None
    wait = sum(s.dur for s in info.program_spans
               if s.name == "serve.wait" and dict(s.meta).get("req") in total)
    return 100.0 * wait / sum(total.values())
