"""Evaluation dashboards: static HTML reports of an action model's eval and
of an ``AIRunner`` run."""
