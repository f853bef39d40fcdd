"""Device seconds per CCD of the pooled pass's plan: the program's span
`render.plan` (photon_pooling.pooled_pass: the plan, build_obj_map with
its torch.cummax, the tree-ring field)."""
from portbench import spans


def read(rec):
    return spans.per_ccd(rec, ("render.plan",))
