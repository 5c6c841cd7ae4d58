"""GAN steps completed in the window times the batch's seconds of audio
(B x segment_size / sample_rate), over the window's seconds."""


def read(record):
    if not record.steps:
        return None
    return record.steps * record.audio_s_per_step / record.window_s
