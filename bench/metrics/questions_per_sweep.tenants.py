"""questions_per_sweep.tenants: how many distinct questions the advisor's
dispatcher sweeps in one engine call (`serve/server.py`), the mean
``questions`` of the program's ``serve.sweep`` spans that start inside
the window. None where no such span carries ``questions``: a program
that sweeps each question on its own records none."""


def read(info):
    n = [dict(s.meta)["questions"] for s in info.program_spans
         if s.name == "serve.sweep" and 0.0 <= s.start < info.window_s
         and "questions" in dict(s.meta)]
    if not n:
        return None
    return sum(n) / len(n)
