"""BLAST (PDSW'13 §3.2, Fig. 7): every app node reads the shared
database and its own query file, searches its share of the queries and
writes its results."""

MB = 1 << 20


def build(n_app, *, n_queries=200, db_mb=1710, per_query_s=4.0, query_mb=1,
          out_mb=8):
    per_node = [n_queries // n_app + (1 if k < n_queries % n_app else 0)
                for k in range(n_app)]
    pre = [("db", db_mb * MB, None)]
    tasks = []
    for k in range(n_app):
        pre.append((f"queries{k}", query_mb * MB, None))
        tasks.append({"tid": k, "inputs": ("db", f"queries{k}"),
                      "outputs": ((f"result{k}", out_mb * MB),),
                      "runtime": per_node[k] * per_query_s, "client": k,
                      "attrs": {}})
    return {"tasks": tasks, "preloaded": pre}
