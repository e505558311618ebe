"""host_path_share.whatif: the share of the traced window spent inside a
request with nothing running on the card: the host's part of
`Predictor.what_if` (scan order, the profiles' service times, the op
arrays' build and copy). Read where requests are annotated (one client)."""


def read(info):
    t = info.trace
    if t is None or not t.device or not t.requests:
        return None
    return 100.0 * t.idle_in_requests_s / t.window_s
