"""The small sizes the CPU tests run the cells at (the widths and points
are cut; the card runs them at their own sizes). At this size float32 CG
parts with summation order sooner, so the reference follows one LM step
and its gap has a limit of its own here, set as the card's are: sound runs
read up to 1.3e-4 (lattice, a start's CG solve stopped at 1e-5), the TF32
control 4.5e-3 and 1.7e-2 (the card's limits are set at the cells'
sizes)."""


def tiny(cell):
    cell.config["spec"]["n_points"] = 12
    cell.config["spec"]["layers"] = [2, 16, 16, 16, 1]
    cell.traffic.update(rung_steps=8, check_every=4, call_steps=3, cg_iters=40)
    if cell.traffic["driver"] == "lm":
        cell.traffic["check_steps"] = 1
        cell.limits = {**cell.limits, "step_loss": 1e-3}
