"""The drivers of the traffic mixes' kinds, one module a kind: ``run(ctx)``
and the end-to-end rate it reports (``RATE_METRIC``)."""
