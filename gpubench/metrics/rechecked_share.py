"""Share of the served users whose list the certificate of the streamed
top-k could not certify and that ran again in FP32
(``topk_streamed.rechecked_users`` over the window), in %."""


def read(r, name):
    users = r.get("users") or 0
    if not users or "rechecked_users" not in r["counters"]:
        return None
    return 100.0 * r["counters"]["rechecked_users"] / users
