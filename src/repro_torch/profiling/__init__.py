"""Phase pricing: the analytic cost model and the phase-timer buckets."""
