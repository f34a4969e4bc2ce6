"""``converge``: CONVERGE windows of ``samples_per_window`` samples, one
after another (``render_frame_async`` then ``finish_frame``, which reads
the frame back), after a warm-up frame of ``warmup_samples``."""

from perfbench.lib.loop import Loop as Base, marked, sync


class Loop(Base):
    unit = "samples"

    def warm_up(self):
        self.frame = self.rs.render_frame(samples=self.mix["warmup_samples"])
        self.samples = self.mix["warmup_samples"]

    def iteration(self) -> int:
        from rfw_tpu_torch.render import RenderStatus
        n = self.mix["samples_per_window"]
        with marked(self.traced, "dispatch"):
            self.rs.render_frame_async(status=RenderStatus.CONVERGE,
                                       samples=n)
        with marked(self.traced, "finish_frame"):
            self.frame = self.rs.finish_frame()
            sync(self.cards)
        self.samples += n
        return n

    def final_state(self) -> dict:
        return {"frame": self.frame, "samples": self.samples}
