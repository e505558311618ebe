"""Broadcast (PDSW'13 Fig. 3, right): one producer, n consumers of its
file, which is replicated ``replication`` times (Fig. 6: 1, 2, 4)."""

MB = 1 << 20


def build(n_consumers=19, *, scale=1, replication=1, file_mb=100, out_mb=1,
          runtime=0.0):
    attr = ({"placement": "broadcast", "replication": replication}
            if replication > 1 else None)
    tasks = [{"tid": 0, "inputs": ("in0",),
              "outputs": (("hot", file_mb * scale * MB),),
              "runtime": runtime, "client": 0,
              "attrs": {"hot": attr} if attr else {}}]
    for k in range(n_consumers):
        tasks.append({"tid": 1 + k, "inputs": ("hot",),
                      "outputs": ((f"out{k}", out_mb * scale * MB),),
                      "runtime": runtime, "client": k, "attrs": {}})
    return {"tasks": tasks, "preloaded": [("in0", file_mb * scale * MB, None)]}
