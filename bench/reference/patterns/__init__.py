"""Workflow builders, one file per pattern, each with ``build(**args)``
returning ``{"tasks": [...], "preloaded": [...]}`` (see `compiler`)."""
