"""Seconds of set-up's ``load_scene`` (parse, mesh bake or geometry cache
read, BVH, transfer to the device), on the host clock."""


def read(r):
    return r.get("load_s")
