"""The system's entry points on the port, counterparts of the scripts in
the repository's ``examples/`` directory. Each module has
``main(argv=None)``, runs as ``python -m repro_torch.examples.<name>``,
takes its script's flags plus ``--device`` (default ``cuda``; it raises
on a host without a card unless given ``--device cpu``) and prints what
its script prints, but for lines that name the device or a wall time.

  provisioning_advisor  the paper's Scenario I and II as a tool
  quickstart            sysid -> predict -> emulate -> what-if
  advisor_server        `serve.AdvisorServer` behind a TCP JSON-lines front
  advisor_client        a multi-tenant client of that server
  serve_batch           batched decode on reduced granite-3-2b, with the
                        shard store planned by the predictor
  train_e2e             `launch.train.train_loop` with a fault and restart

Nothing here runs at import.
"""
