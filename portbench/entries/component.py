"""Traffic entry ``component``: ``FusionComponent(cfg, device)``, the
node as upstream writes it.

A frame is one ``callback_depthmap`` a camera, the sync policy's trigger
slot 0 last so that the tuple it completes holds every camera, after the
frame's ``callback_point_sequence`` packets; then ``tick_resample``, the
resample timer's body, runs the step and publishes through
``on_points``.
"""

from pb import drive


class Entry:
    def __init__(self, system, cfg, traffic, device):
        from ros_gpu_depthmap_fusion_tpu_torch.pipeline.component import (
            FusionComponent)
        self.system = system
        self.comp = FusionComponent(cfg, device, on_points=system.publish)
        self.engine = self.comp.engine
        spans = system.spans
        spans.wrap(self.comp, "callback_depthmap", drive.CALLBACK)
        spans.wrap(self.comp, "tick_resample", drive.TICK)
        drive.wrap_engine(self.engine, spans)
        c = system.scene.c
        self.slot_order = list(range(1, c)) + [0]

    def feed(self, f: int) -> None:
        sc, comp = self.system.scene, self.comp
        depth, poses, stamp = sc.depth(f), sc.poses(f), sc.stamp(f)
        for pts, sec, nsec in sc.lidar(f):
            comp.callback_point_sequence(sec + nsec * 1e-9, pts, drive.EYE)
        for slot in self.slot_order:
            comp.callback_depthmap(slot, stamp, depth[slot], sc.intr,
                                   poses[slot], poses[slot])
        comp.tick_resample(stamp)

    def close(self) -> None:
        self.engine.close()
