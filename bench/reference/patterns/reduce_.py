"""Reduce (PDSW'13 Fig. 3, middle): n producers, one consumer. WASS
collocates the intermediate files on one node and writes the result
locally."""

MB = 1 << 20


def build(n_workers=19, *, scale=1, wass=False, in_mb=100, mid_mb=100,
          out_mb=200, runtime=0.0):
    coll = {"placement": "collocate", "group": "reduce"} if wass else None
    local = {"placement": "local"} if wass else None
    pre = [(f"in{k}", in_mb * scale * MB, None) for k in range(n_workers)]
    tasks = [{"tid": k, "inputs": (f"in{k}",),
              "outputs": ((f"mid{k}", mid_mb * scale * MB),),
              "runtime": runtime, "client": k,
              "attrs": {f"mid{k}": coll} if coll else {}}
             for k in range(n_workers)]
    tasks.append({"tid": n_workers,
                  "inputs": tuple(f"mid{k}" for k in range(n_workers)),
                  "outputs": (("reduced", out_mb * scale * MB),),
                  "runtime": runtime, "client": None,
                  "attrs": {"reduced": local} if local else {}})
    return {"tasks": tasks, "preloaded": pre}
