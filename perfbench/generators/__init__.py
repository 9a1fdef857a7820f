"""General traffic generators: a traffic file names one of these modules
(``"generator"``) and gives its parameters. A generator refuses a key it
does not read (:func:`check_keys`), so that a setting it does not implement
is never silently ignored."""

__all__ = ["check_keys"]


def check_keys(traffic: dict, known) -> None:
    extra = sorted(set(traffic) - set(known) - {"generator"})
    if extra:
        raise ValueError(f"traffic {traffic.get('generator')!r} does not "
                         f"implement {', '.join(extra)}")
