"""Plan rewrites for split execution: the fragment cut and the
partial/final aggregation split (``fragmenter``, ``agg_split``). The
multi-device exchange is not ported yet."""
