"""``n_pipes`` parallel three-stage pipelines (PDSW'13 Fig. 3, left).
WASS keeps the two intermediate files on the writer's node."""

MB = 1 << 20


def build(n_pipes=19, *, scale=1, wass=False, stage_mb=(100, 200, 100, 10),
          runtime=0.0):
    attr = {"placement": "local"} if wass else None
    tasks, pre, tid = [], [], 0
    for p in range(n_pipes):
        pre.append((f"in{p}", stage_mb[0] * scale * MB, None))
        prev = f"in{p}"
        for s in range(3):
            out = f"p{p}s{s}"
            tasks.append({"tid": tid, "inputs": (prev,),
                          "outputs": ((out, stage_mb[s + 1] * scale * MB),),
                          "runtime": runtime, "client": p,
                          "attrs": {out: attr} if (attr and s < 2) else {}})
            prev = out
            tid += 1
    return {"tasks": tasks, "preloaded": pre}
