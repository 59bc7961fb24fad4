"""The benchmark's yardstick: how a cell is found, made from its seed,
driven, timed, traced and judged. Nothing here is edited by a later PR."""
