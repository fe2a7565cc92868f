"""Share of the positions the HSTU tower computed that are padding: one
less the valid positions of the window's histories (each history's last
``T`` items) over the program's counter ``hstu_apply.positions`` over the
window, in %. ``None`` where the window computed no position."""


def read(r, name):
    computed, valid = r.get("tower_positions_computed"), r.get("tower_positions")
    if not computed or valid is None:
        return None
    return 100.0 * (1.0 - valid / computed)
