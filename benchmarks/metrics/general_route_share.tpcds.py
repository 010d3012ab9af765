"""Percent of the window's join and groupby calls that ran the eager
general route (``rel.route.join.general.<how>``,
``rel.route.groupby.general``) among all of them, the dense routes'
(``rel.route.join.dense.<how>``, ``.presence_bitmap.<how>``,
``rel.route.groupby.dense.<method>``) included. A plan that left the
fused route counts its calls before it left as well. None where the
program counts no route."""

GENERAL = ("rel.route.join.general.", "rel.route.groupby.general")
DENSE = ("rel.route.join.dense.", "rel.route.join.presence_bitmap.",
         "rel.route.groupby.dense.")


def read(ctx):
    routes = getattr(ctx.window, "routes", None)
    if not routes:
        return None
    general = sum(v for k, v in routes.items() if k.startswith(GENERAL))
    dense = sum(v for k, v in routes.items() if k.startswith(DENSE))
    if general + dense == 0:
        return None
    return 100.0 * general / (general + dense)
