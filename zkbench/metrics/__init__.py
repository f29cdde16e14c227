"""One reader a metric: ``zkbench/metrics/<name>.py`` defines ``read(ctx)``
(a :class:`zkbench.run.Ctx`), which returns the metric's value, or ``None``
where the run has nothing to read it from (the metric is then left out)."""
