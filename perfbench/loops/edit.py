"""``edit``: edits, each an instance move (``InstanceRef.translate``),
``RenderSystem.synchronize()`` and a frame of ``frame_samples`` samples
read back.

Edit i puts a movable instance drawn from the seed at an offset drawn
from the seed from where the scene placed it: a random direction, and a
length between ``min_offset`` and ``max_offset`` times the instance's
scale. So the walk is bounded, and every instance an edit touched ends
away from its place. The move is the difference from the instance's
present offset, as a user drags it. With ``sync_update`` (traced runs)
the run's cards are synchronised after each update, so that ``update_s``
times the update's device work too. After each move the capture of the
intersector's rays looks also at the rays that meet the moved
instance's bounding sphere, at its place before and after."""

import time

import numpy as np

from perfbench.lib import geometry
from perfbench.lib.loop import Loop as Base, marked, sync


class Loop(Base):
    unit = "edits"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.count = 0
        self.movable = [i for i, inst in enumerate(self.layout)
                        if inst["movable"]]
        self.home = {i: geometry.bounding_sphere(self.layout[i])
                     for i in self.movable}
        self.offset = {}

    def target(self, i: int):
        """Edit ``i``: (instance index, float32 offset from its place)."""
        g = np.random.default_rng([self.seed, 2, i])
        inst = self.movable[int(g.integers(len(self.movable)))]
        d = g.normal(size=3)
        d /= np.linalg.norm(d)
        length = g.uniform(self.mix["min_offset"], self.mix["max_offset"])
        scale = float(self.layout[inst]["scale"][0])
        return inst, (d * length * scale).astype(np.float32)

    def move(self, i: int, offset: dict):
        """Edit ``i`` as the translation it applies, given the offsets
        the earlier edits left (updated)."""
        inst, off = self.target(i)
        delta = (off - offset.get(inst, np.zeros(3, np.float32))).astype(
            np.float32)
        offset[inst] = off
        return inst, delta

    def _edit(self):
        inst, delta = self.move(self.count, self.offset)
        t0 = time.perf_counter()
        with marked(self.traced, "update"):
            self.refs[inst].translate(delta)
            self.rs.synchronize()
            if self.sync_update:
                sync(self.cards)
        self.update_s.append(time.perf_counter() - t0)
        self.count += 1
        c, r = self.home[inst]
        self.cap.set_focus(self.count, [(c, r), (c + self.offset[inst], r)])
        with marked(self.traced, "finish_frame"):
            self.frame = self.rs.render_frame(
                samples=self.mix["frame_samples"])
            sync(self.cards)

    def warm_up(self):
        self._edit()
        self._edit()
        self.update_s = []

    def iteration(self) -> int:
        self._edit()
        return 1

    def final_state(self) -> dict:
        import torch
        scene = self.rs.context._scene
        tables = {k: scene[k].cpu().numpy() if torch.is_tensor(scene[k])
                  else np.asarray(scene[k])
                  for k in ("tri_vertices", "tri_instance", "tri_prim")}
        offset: dict = {}
        moves = [self.move(i, offset) for i in range(self.count)]
        return {"frame": self.frame, "samples": self.mix["frame_samples"],
                "moves": moves, "tables": tables}
