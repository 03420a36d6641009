"""Scene description (.sp DSL) parser.

Host-side port of ``base/FileParser.cpp`` with the same
grammar and the same 4-pass semantics (FileParser.cpp:843-925):

  pass 0: scene_parameters
  pass 1: material_lambertian / material_glossy /
          material_transmissive_dielectric / environment_light /
          sphere_light / perspective_camera
  pass 2: material_clearcoat (resolves base by name)
  pass 3: mesh / plane / sphere / instance

plus: version gate (must be 1), comment/blank-line stripping with a
char→line-number map for error messages, validation pass against the sorted
top-level type list, transform accumulation in listed order
(transform = transform ∘ new), and the same stubs (``instance`` and
``material_transmissive_dielectric`` log a warning and are ignored,
FileParser.cpp:372-377, 525-530).

Output is a ``ParsedScene`` of plain numpy/host data; ``build.py`` turns it
into the SceneArrays pytree.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import os
import re
from typing import Optional

import numpy as np

from .types import INTEGRATORS

logger = logging.getLogger("simplepath_tpu_torch")

__all__ = ["ParsingError", "parse_sp", "ParsedScene"]

_VALID_TOP_LEVEL = {
    "environment_light", "instance", "material_clearcoat", "material_glossy",
    "material_lambertian", "material_transmissive_dielectric", "mesh",
    "perspective_camera", "plane", "scene_parameters", "sphere", "sphere_light",
}


class ParsingError(RuntimeError):
    """ParsingException (FileParser.cpp:35-54): message + line number."""

    def __init__(self, msg: str, line: int | None = None):
        super().__init__(f"{msg} on line {line}" if line is not None else msg)


@dataclasses.dataclass
class MaterialDef:
    kind: str                      # "lambertian" | "glossy" | "clearcoat"
    albedo: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    ior: float = 1.5
    base: Optional[str] = None     # clearcoat base name
    cc_color: tuple = (1.0, 1.0, 1.0)
    cc_ior: float = 1.5


@dataclasses.dataclass
class GeometryDef:
    kind: str                      # "sphere" | "plane" | "mesh"
    material: Optional[str]
    transform: tuple               # (linear 3x3, translation 3) numpy fwd
    inverse: tuple                 # (linear 3x3, translation 3) numpy inv
    mesh_path: Optional[str] = None


@dataclasses.dataclass
class LightDef:
    kind: str                      # "sphere_light" | "environment_light"
    radiance: tuple = (1.0, 1.0, 1.0)
    transform: tuple | None = None
    inverse: tuple | None = None
    image: Optional[str] = None
    max_radiance: float = float(np.finfo(np.float32).max)


@dataclasses.dataclass
class CameraDef:
    origin: tuple = (0.0, 0.0, 0.0)
    look_at: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    fov: float = 45.0


@dataclasses.dataclass
class ParsedScene:
    width: int = 512
    height: int = 512
    russian_roulette_depth: int = 3
    max_depth: int = 10
    integrator: Optional[str] = None          # None = NotSpecified
    output_file_name: str = ""
    camera: Optional[CameraDef] = None
    materials: dict = dataclasses.field(default_factory=dict)
    geometry: list = dataclasses.field(default_factory=list)
    lights: list = dataclasses.field(default_factory=list)
    base_dir: str = "."


# ---------------------------------------------------------------- lexing

def _file_to_string(text: str) -> tuple[str, list[int]]:
    """Strip comments/blank lines; map each char to its source line
    (FileParser.cpp:821-841)."""
    contents = []
    line_numbers: list[int] = []
    for lineno, line in enumerate(text.splitlines(), start=1):
        trimmed = line.strip()
        if not trimmed or trimmed.startswith("#"):
            continue
        trimmed = trimmed.split("#", 1)[0].strip()
        if not trimmed:
            continue
        contents.append(trimmed)
        line_numbers.extend([lineno] * (len(trimmed) + 1))
    return " ".join(c for c in contents) + (" " if contents else ""), line_numbers


class _Stream:
    """Token stream over the cleaned text with tellg-style positions."""

    _token_re = re.compile(r"[A-Za-z0-9_]+")

    def __init__(self, text: str, line_numbers: list[int], offset: int = 0):
        self.text = text
        self.lines = line_numbers
        self.pos = 0
        self.offset = offset

    def line(self) -> int:
        i = min(self.offset + self.pos, len(self.lines) - 1)
        return self.lines[i] if self.lines else 0

    def eof(self) -> bool:
        self._skip_ws()
        return self.pos >= len(self.text)

    def _skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def token(self) -> str:
        """Identifier token (letters/digits/underscore), like Token
        (FileParser.cpp:112-147)."""
        self._skip_ws()
        m = self._token_re.match(self.text, self.pos)
        if not m:
            return ""
        self.pos = m.end()
        return m.group(0)

    def consume(self, ch: str):
        self._skip_ws()
        if self.pos >= len(self.text) or self.text[self.pos] != ch:
            raise ParsingError(f"Expected '{ch}' character", self.line())
        self.pos += 1

    def word(self) -> str:
        """Whitespace-delimited word (istream >> string semantics)."""
        self._skip_ws()
        start = self.pos
        while self.pos < len(self.text) and not self.text[self.pos].isspace():
            self.pos += 1
        return self.text[start:self.pos]

    def quoted_or_word(self) -> str:
        """std::filesystem::path extraction honors quotes."""
        self._skip_ws()
        if self.pos < len(self.text) and self.text[self.pos] == '"':
            end = self.text.index('"', self.pos + 1)
            val = self.text[self.pos + 1:end]
            self.pos = end + 1
            return val
        return self.word().strip('"')

    def number(self) -> float:
        w = self.word().rstrip(",")
        try:
            return float(w)
        except ValueError:
            raise ParsingError(f"Expected number, got '{w}'", self.line())

    def vec3(self) -> tuple[float, float, float]:
        return (self.number(), self.number(), self.number())

    def body(self) -> tuple[str, int]:
        """Read until '}' (getline(ins, body, '}')); returns (body, offset)."""
        start = self.pos
        end = self.text.find("}", self.pos)
        if end < 0:
            end = len(self.text)
        body = self.text[start:end]
        self.pos = end + 1
        return body, self.offset + start


# ---------------------------------------------------------------- transforms

def _rotate_matrix(axis, degrees) -> np.ndarray:
    u = np.asarray(axis, np.float64)
    u = u / np.linalg.norm(u)
    r = np.radians(float(degrees))
    s, c = np.sin(r), np.cos(r)
    x, y, z = u
    return np.array([
        [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s],
        [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c],
    ], np.float64)


class _TransformAccum:
    """Forward+inverse accumulation in listed order (Transformation.h:95-101)."""

    def __init__(self):
        self.fl = np.eye(3)
        self.ft = np.zeros(3)
        self.il = np.eye(3)
        self.it = np.zeros(3)

    def _append(self, lin, t, lin_inv, t_inv):
        # fwd = fwd ∘ new ; inv = new_inv ∘ inv
        self.ft = self.fl @ t + self.ft
        self.fl = self.fl @ lin
        self.it = lin_inv @ self.it + t_inv
        self.il = lin_inv @ self.il

    def translate(self, v):
        v = np.asarray(v, np.float64)
        self._append(np.eye(3), v, np.eye(3), -v)

    def rotate(self, axis, degrees):
        m = _rotate_matrix(axis, degrees)
        self._append(m, np.zeros(3), m.T, np.zeros(3))

    def scale(self, s):
        s = np.asarray(s, np.float64)
        if np.any(s == 0.0):
            raise ParsingError("Unable to handle zero scale")
        self._append(np.diag(s), np.zeros(3), np.diag(1.0 / s), np.zeros(3))

    def fwd(self):
        return self.fl.astype(np.float32), self.ft.astype(np.float32)

    def inv(self):
        return self.il.astype(np.float32), self.it.astype(np.float32)


# ---------------------------------------------------------------- block parsers

def _attr_loop(stream: _Stream):
    while not stream.eof():
        word = stream.token()
        if not word:
            break
        stream.consume(":")
        yield word


def _parse_scene_parameters(ps: ParsedScene, stream: _Stream):
    for word in _attr_loop(stream):
        if word == "output_file_name":
            ps.output_file_name = stream.quoted_or_word()
        elif word == "width":
            ps.width = int(stream.number())
        elif word == "height":
            ps.height = int(stream.number())
        elif word == "russian_roulette_depth":
            ps.russian_roulette_depth = int(stream.number())
        elif word == "max_depth":
            ps.max_depth = int(stream.number())
        elif word == "integrator":
            name = stream.word().strip()
            if name not in INTEGRATORS:
                raise ParsingError(f"Unknown integrator type: {name}", stream.line())
            ps.integrator = name
        else:
            raise ParsingError(f"Unknown scene_parameters attribute: {word}",
                               stream.line())


def _parse_material_lambertian(ps: ParsedScene, stream: _Stream):
    name, albedo = "", (0.0, 0.0, 0.0)
    for word in _attr_loop(stream):
        if word == "name":
            name = stream.quoted_or_word()
        elif word == "diffuse":
            albedo = stream.vec3()
        else:
            raise ParsingError(f"Unknown material_lambertian attribute: {word}",
                               stream.line())
    if not name:
        raise ParsingError("Material needs named", stream.line())
    if name in ps.materials:
        raise ParsingError(f"Material {name} already exists", stream.line())
    ps.materials[name] = MaterialDef(kind="lambertian", albedo=albedo)


def _parse_material_glossy(ps: ParsedScene, stream: _Stream):
    name, color, roughness, ior = "", (0.0, 0.0, 0.0), 0.5, 1.5
    for word in _attr_loop(stream):
        if word == "name":
            name = stream.quoted_or_word()
        elif word == "diffuse":
            color = stream.vec3()
        elif word == "roughness":
            roughness = stream.number()
        elif word == "ior":
            ior = stream.number()
        else:
            raise ParsingError(f"Unknown material_glossy attribute: {word}",
                               stream.line())
    if not name:
        raise ParsingError("Material needs named", stream.line())
    if name in ps.materials:
        raise ParsingError(f"Material {name} already exists", stream.line())
    ps.materials[name] = MaterialDef(kind="glossy", albedo=color,
                                     roughness=roughness, ior=ior)


def _parse_material_clearcoat(ps: ParsedScene, stream: _Stream):
    name, base, ior, color = "", None, 1.5, (1.0, 1.0, 1.0)
    for word in _attr_loop(stream):
        if word == "name":
            name = stream.quoted_or_word()
        elif word == "base":
            base_name = stream.quoted_or_word()
            if base_name in ps.materials:
                base = base_name
            else:
                logger.error("Material '%s' not found", base_name)
        elif word == "color":
            color = stream.vec3()
        elif word == "ior":
            ior = stream.number()
        else:
            raise ParsingError(f"Unknown material_clearcoat attribute: {word}",
                               stream.line())
    if not name:
        raise ParsingError("Material needs named", stream.line())
    if base is None:
        raise ParsingError("Clearcoat material needs a base material", stream.line())
    if name in ps.materials:
        raise ParsingError(f"Material {name} already exists", stream.line())
    ps.materials[name] = MaterialDef(kind="clearcoat", base=base,
                                     cc_ior=ior, cc_color=color)


def _parse_transform_attrs(stream: _Stream, word: str, accum: _TransformAccum) -> bool:
    if word == "translate":
        accum.translate(stream.vec3())
    elif word == "rotate":
        axis = stream.vec3()
        deg = stream.number()
        accum.rotate(axis, deg)
    elif word == "scale":
        accum.scale(stream.vec3())
    else:
        return False
    return True


def _parse_geometry(ps: ParsedScene, stream: _Stream, kind: str):
    accum = _TransformAccum()
    material = None
    mesh_path = None
    for word in _attr_loop(stream):
        if word == "material":
            mname = stream.quoted_or_word()
            if mname in ps.materials:
                material = mname
            else:
                logger.error("Material '%s' not found", mname)
        elif word == "file" and kind == "mesh":
            mesh_path = stream.quoted_or_word()
        elif word == "name":
            stream.quoted_or_word()  # accepted and ignored (example_scene.sp)
        elif _parse_transform_attrs(stream, word, accum):
            pass
        else:
            raise ParsingError(f"Unknown {kind} attribute: {word}", stream.line())
    ps.geometry.append(GeometryDef(kind=kind, material=material,
                                   transform=accum.fwd(), inverse=accum.inv(),
                                   mesh_path=mesh_path))


def _parse_sphere_light(ps: ParsedScene, stream: _Stream):
    accum = _TransformAccum()
    radiance = (1.0, 1.0, 1.0)
    for word in _attr_loop(stream):
        if word == "radiance":
            radiance = stream.vec3()
        elif _parse_transform_attrs(stream, word, accum):
            pass
        else:
            raise ParsingError(f"Unknown environment light attribute: {word}",
                               stream.line())
    ps.lights.append(LightDef(kind="sphere_light", radiance=radiance,
                              transform=accum.fwd(), inverse=accum.inv()))


def _parse_environment_light(ps: ParsedScene, stream: _Stream):
    accum = _TransformAccum()
    radiance = (1.0, 1.0, 1.0)
    max_radiance = float(np.finfo(np.float32).max)
    image = None
    for word in _attr_loop(stream):
        if word == "radiance":
            radiance = stream.vec3()
        elif word == "max_radiance":
            max_radiance = stream.number()
        elif word == "image":
            image = stream.quoted_or_word()
        elif word in ("rotate", "scale"):
            _parse_transform_attrs(stream, word, accum)
        else:
            raise ParsingError(f"Unknown environment light attribute: {word}",
                               stream.line())
    ps.lights.append(LightDef(kind="environment_light", radiance=radiance,
                              transform=accum.fwd(), inverse=accum.inv(),
                              image=image, max_radiance=max_radiance))


def _parse_perspective_camera(ps: ParsedScene, stream: _Stream):
    cam = CameraDef()
    for word in _attr_loop(stream):
        if word == "origin":
            cam.origin = stream.vec3()
        elif word == "look_at":
            cam.look_at = stream.vec3()
        elif word == "up":
            cam.up = stream.vec3()
        elif word == "fov":
            cam.fov = stream.number()
        else:
            raise ParsingError(f"Unknown perspective_camera attribute: {word}",
                               stream.line())
    ps.camera = cam


def _parse_stub(what: str):
    def fn(ps, stream):
        logger.warning("No support for %s yet", what)
    return fn


_PASS_PARSERS = {
    "scene_parameters": _parse_scene_parameters,
    "material_lambertian": _parse_material_lambertian,
    "material_glossy": _parse_material_glossy,
    "material_clearcoat": _parse_material_clearcoat,
    "material_transmissive_dielectric": _parse_stub("transmissive dielectric"),
    "environment_light": _parse_environment_light,
    "sphere_light": _parse_sphere_light,
    "perspective_camera": _parse_perspective_camera,
    "mesh": lambda ps, s: _parse_geometry(ps, s, "mesh"),
    "plane": lambda ps, s: _parse_geometry(ps, s, "plane"),
    "sphere": lambda ps, s: _parse_geometry(ps, s, "sphere"),
    "instance": _parse_stub("instances"),
}

_PASSES = [
    {"scene_parameters"},
    {"environment_light", "material_glossy", "material_lambertian",
     "material_transmissive_dielectric", "perspective_camera", "sphere_light"},
    {"material_clearcoat"},
    {"instance", "mesh", "plane", "sphere"},
]


def parse_sp(source, base_dir: str | None = None) -> ParsedScene:
    """Parse a .sp scene from a path, file object, or string."""
    if hasattr(source, "read"):
        text = source.read()
        base = base_dir or "."
    elif isinstance(source, str) and ("\n" in source or "{" in source) \
            and not os.path.exists(source):
        text = source
        base = base_dir or "."
    else:
        with open(source) as f:
            text = f.read()
        base = base_dir or os.path.dirname(os.path.abspath(source))

    contents, line_numbers = _file_to_string(text)
    ps = ParsedScene(base_dir=base)

    stream = _Stream(contents, line_numbers)
    tok = stream.token()
    if tok != "version":
        raise ParsingError("Expects version as first directive")
    stream.consume(":")
    version = int(stream.number())
    if version != 1:
        raise ParsingError(f"Unable to parse version {version}")
    post_version = stream.pos

    # validation pass (FileParser.cpp:862-877)
    while not stream.eof():
        word = stream.token()
        if not word:
            break
        stream.consume("{")
        if word not in _VALID_TOP_LEVEL:
            raise ParsingError(f"Unknown type '{word}'", stream.line())
        stream.body()

    for active in _PASSES:
        stream.pos = post_version
        while not stream.eof():
            word = stream.token()
            if not word:
                break
            stream.consume("{")
            body, offset = stream.body()
            if word in active:
                _PASS_PARSERS[word](ps, _Stream(body, line_numbers, offset))
    return ps
