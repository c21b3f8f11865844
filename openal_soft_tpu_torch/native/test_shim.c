/* C smoke test for libopenal_torch.so: the reference's client patterns
 * against the PyTorch renderer through the classic C ABI.
 *
 * Scenario 1 (alplay): loopback open, static buffer, source, play, render.
 * Scenario 2 (alstream + alreverb): a streaming source fed by queued
 * buffers with unqueue-and-refill, routed through an EAXReverb effect
 * slot (alGenEffects/alEffecti/alGenAuxiliaryEffectSlots/alSource3i).
 *
 * Prints PEAK=<value> STREAM_PEAK=<value> and exits 0 on success.
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define AL_BUFFER 0x1009
#define AL_LOOPING 0x1007
#define AL_POSITION 0x1004
#define AL_GAIN 0x100A
#define AL_SOURCE_STATE 0x1010
#define AL_PLAYING 0x1012
#define AL_FORMAT_MONO_FLOAT32 0x10010
#define AL_NO_ERROR 0
#define AL_EFFECT_TYPE 0x8001
#define AL_EFFECT_EAXREVERB 0x8000
#define AL_EAXREVERB_DECAY_TIME 0x0006
#define AL_EFFECTSLOT_EFFECT 0x0001
#define AL_AUXILIARY_SEND_FILTER 0x20006
#define AL_FILTER_TYPE 0x8001
#define AL_FILTER_LOWPASS 0x0001
#define AL_LOWPASS_GAINHF 0x0002
#define AL_DIRECT_FILTER 0x20005

typedef void ALCdevice;
typedef void ALCcontext;
extern ALCdevice *alcLoopbackOpenDeviceSOFT(const char *devname);
extern ALCcontext *alcCreateContext(ALCdevice *dev, const int *attrs);
extern char alcMakeContextCurrent(ALCcontext *ctx);
extern void alcRenderSamplesSOFT(ALCdevice *dev, void *buffer, int samples);
extern void alGenBuffers(int n, unsigned *buffers);
extern void alDeleteBuffers(int n, const unsigned *buffers);
extern void alBufferData(unsigned buffer, int format, const void *data,
                         int size, int freq);
extern void alGenSources(int n, unsigned *sources);
extern void alDeleteSources(int n, const unsigned *sources);
extern void alSourcei(unsigned source, int param, int value);
extern void alSourcef(unsigned source, int param, float value);
extern void alSource3f(unsigned source, int param, float x, float y, float z);
extern void alSource3i(unsigned source, int param, int a, int b, int c);
extern void alSourcePlay(unsigned source);
extern void alSourceStop(unsigned source);
extern void alSourceQueueBuffers(unsigned source, int n, const unsigned *b);
extern void alSourceUnqueueBuffers(unsigned source, int n, unsigned *b);
extern void alGetSourcei(unsigned source, int param, int *value);
extern void alGenEffects(int n, unsigned *effects);
extern void alEffecti(unsigned effect, int param, int value);
extern void alEffectf(unsigned effect, int param, float value);
extern void alGenAuxiliaryEffectSlots(int n, unsigned *slots);
extern void alAuxiliaryEffectSloti(unsigned slot, int param, int value);
extern void alGenFilters(int n, unsigned *filters);
extern void alFilteri(unsigned filter, int param, int value);
extern void alFilterf(unsigned filter, int param, float value);
extern int alGetError(void);
extern void *alcCaptureOpenDevice(const char *name, unsigned freq, int fmt,
                                  int samples);
extern char alcCaptureCloseDevice(void *dev);
extern void alcCaptureStart(void *dev);
extern void alcCaptureStop(void *dev);
extern void alcCaptureSamples(void *dev, void *buf, int samples);
extern void alcGetIntegerv(void *dev, int param, int size, int *values);
extern int EAXSet(const void *psid, unsigned pid, unsigned src, void *value,
                  unsigned size);
extern int EAXGet(const void *psid, unsigned pid, unsigned src, void *value,
                  unsigned size);
extern char alEAXSetBufferMode(int n, const unsigned *buffers, int value);
extern int alEAXGetBufferMode(unsigned buffer, int *reserved);
extern void alSourcefDirect(void *ctx, unsigned src, int param, float v);
extern void alGetSourcefDirect(void *ctx, unsigned src, int param, float *v);
extern void alGetListenerf(int param, float *v);
extern char alIsSource(unsigned src);
extern int alGetInteger(int param);
extern const char *alGetStringiSOFT(int param, int index);
extern void alDebugMessageInsertEXT(int source, int type, unsigned id,
                                    int severity, int length,
                                    const char *msg);

extern void alBufferCallbackSOFT(unsigned buffer, int format, int freq,
                                 int (*cb)(void*, void*, int), void *user);
extern void alGetBufferPtrSOFT(unsigned buffer, int param, void **ptr);

#define RATE 48000
#define FRAMES 4096

/* AL_SOFT_callback_buffer pull: a 220 Hz tone streamed on demand. */
static int g_cb_calls = 0;
static int g_cb_phase = 0;

static int tone_callback(void *user, void *sampledata, int numbytes)
{
    (void)user;
    float *f = sampledata;
    int frames = numbytes / 4;
    for(int i = 0; i < frames; ++i)
        f[i] = 0.3f * (float)sin(2.0 * M_PI * 220.0 * (g_cb_phase + i)
                                 / RATE);
    g_cb_phase += frames;
    ++g_cb_calls;
    return frames * 4;
}

static float peak_of(const float *buf, int n)
{
    float peak = 0.0f;
    for(int i = 0; i < n; ++i) {
        float a = fabsf(buf[i]);
        if(a > peak) peak = a;
        if(a != a) return -1.0f;   /* NaN */
    }
    return peak;
}

static void fill_tone(float *data, int n, double freq, int phase0)
{
    for(int i = 0; i < n; ++i)
        data[i] = 0.4f * (float)sin(2.0 * M_PI * freq * (phase0 + i) / RATE);
}

int main(void)
{
    ALCdevice *dev = alcLoopbackOpenDeviceSOFT(NULL);
    if(!dev) { fprintf(stderr, "open failed\n"); return 1; }
    ALCcontext *ctx = alcCreateContext(dev, NULL);
    alcMakeContextCurrent(ctx);

    /* --- scenario 1: static looping source ---------------------------- */
    float *tone = malloc(sizeof(float) * RATE);
    fill_tone(tone, RATE, 440.0, 0);
    unsigned buf, src;
    alGenBuffers(1, &buf);
    alBufferData(buf, AL_FORMAT_MONO_FLOAT32, tone, RATE * 4, RATE);
    alGenSources(1, &src);
    alSourcei(src, AL_BUFFER, (int)buf);
    alSourcei(src, AL_LOOPING, 1);
    alSource3f(src, AL_POSITION, 0.5f, 0.0f, -1.0f);
    alSourcePlay(src);

    float *out = malloc(sizeof(float) * FRAMES * 2);
    alcRenderSamplesSOFT(dev, out, FRAMES);
    float peak = peak_of(out, FRAMES * 2);
    if(peak <= 0.0f || peak > 2.0f) {
        fprintf(stderr, "bad peak %f\n", peak);
        return 1;
    }
    int state = 0;
    alGetSourcei(src, AL_SOURCE_STATE, &state);
    if(state != AL_PLAYING) { fprintf(stderr, "not playing\n"); return 1; }
    alSourceStop(src);

    /* --- scenario 2: streaming queue + EAXReverb send + direct filter - */
    unsigned slot, effect, filter;
    alGenEffects(1, &effect);
    alEffecti(effect, AL_EFFECT_TYPE, AL_EFFECT_EAXREVERB);
    alEffectf(effect, AL_EAXREVERB_DECAY_TIME, 3.1f);
    alGenAuxiliaryEffectSlots(1, &slot);
    alAuxiliaryEffectSloti(slot, AL_EFFECTSLOT_EFFECT, (int)effect);
    alGenFilters(1, &filter);
    alFilteri(filter, AL_FILTER_TYPE, AL_FILTER_LOWPASS);
    alFilterf(filter, AL_LOWPASS_GAINHF, 0.3f);

    unsigned sbufs[3], ssrc;
    alGenBuffers(3, sbufs);
    float *chunk = malloc(sizeof(float) * 8192);
    int phase = 0;
    for(int i = 0; i < 3; ++i) {
        fill_tone(chunk, 8192, 330.0, phase);
        phase += 8192;
        alBufferData(sbufs[i], AL_FORMAT_MONO_FLOAT32, chunk, 8192 * 4, RATE);
    }
    alGenSources(1, &ssrc);
    alSourceQueueBuffers(ssrc, 3, sbufs);
    alSourcei(ssrc, AL_DIRECT_FILTER, (int)filter);
    alSource3i(ssrc, AL_AUXILIARY_SEND_FILTER, (int)slot, 0, 0);
    alSourcePlay(ssrc);

    float speak = 0.0f;
    for(int blocks = 0; blocks < 8; ++blocks) {
        alcRenderSamplesSOFT(dev, out, FRAMES);
        float p = peak_of(out, FRAMES * 2);
        if(p < 0.0f) { fprintf(stderr, "NaN in stream\n"); return 1; }
        if(p > speak) speak = p;
        unsigned done[3];
        alSourceUnqueueBuffers(ssrc, 1, done);
    }
    if(speak <= 0.0f) { fprintf(stderr, "silent stream\n"); return 1; }

    if(alGetError() != AL_NO_ERROR) {
        fprintf(stderr, "AL error\n");
        return 1;
    }
    alDeleteSources(1, &ssrc);
    alDeleteBuffers(3, sbufs);

    /* --- scenario 3: getters, Direct variants, X-RAM ------------------- */
    alSourcefDirect(ctx, src, AL_GAIN, 0.5f);
    float g = -1.0f;
    alGetSourcefDirect(ctx, src, AL_GAIN, &g);
    if(g < 0.49f || g > 0.51f) {
        fprintf(stderr, "Direct gain roundtrip %f\n", g);
        return 1;
    }
    alGetListenerf(AL_GAIN, &g);
    if(g != 1.0f) { fprintf(stderr, "listener gain %f\n", g); return 1; }
    if(!alIsSource(src)) { fprintf(stderr, "alIsSource\n"); return 1; }
    if(alGetInteger(0xD000) == 0) {     /* AL_DISTANCE_MODEL */
        fprintf(stderr, "distance model\n");
        return 1;
    }
    const char *rs = alGetStringiSOFT(0x1213, 0);   /* RESAMPLER_NAME */
    if(!rs || !rs[0]) { fprintf(stderr, "resampler name\n"); return 1; }
    if(!alEAXSetBufferMode(1, &buf, 0x1552)) {      /* STORAGE_AUTOMATIC */
        fprintf(stderr, "xram set\n");
        return 1;
    }
    if(alEAXGetBufferMode(buf, NULL) != 0x1552) {
        fprintf(stderr, "xram get\n");
        return 1;
    }
    alDebugMessageInsertEXT(0x19B7, 0x19BB, 1, 0x19BE, -1, "shim-test");

    /* --- scenario 4: EAXSet/EAXGet (EAX 2.0 listener over the GUID ABI) */
    struct { unsigned d1; unsigned short d2, d3; unsigned char d4[8]; }
        eax2_listener = { 0x0306a6a8, 0xb224, 0x11d2,
                          {0x99, 0xe5, 0x00, 0x00, 0xe8, 0xd8, 0xc7, 0x22} };
    unsigned env = 10;                      /* EAX_ENVIRONMENT_HANGAR */
    if(EAXSet(&eax2_listener, 11, 0, &env, sizeof(env)) != 0) {
        fprintf(stderr, "EAXSet environment\n");
        return 1;
    }
    float decay = 0.0f;
    if(EAXGet(&eax2_listener, 5, 0, &decay, sizeof(decay)) != 0
       || decay < 2.0f) {                   /* hangar decay ~10 s */
        fprintf(stderr, "EAXGet decay %f\n", decay);
        return 1;
    }

    /* --- scenario 5: capture ------------------------------------------- */
    void *cap = alcCaptureOpenDevice(NULL, 44100, 0x1101, 4096);
    if(!cap) { fprintf(stderr, "capture open\n"); return 1; }
    alcCaptureStart(cap);
    int avail = 0;
    for(int spin = 0; spin < 1000000 && avail < 256; ++spin)
        alcGetIntegerv(cap, 0x312, 1, &avail);   /* ALC_CAPTURE_SAMPLES */
    short cbuf[256];
    memset(cbuf, 0x55, sizeof(cbuf));
    int got = avail < 256 ? avail : 256;
    alcCaptureSamples(cap, cbuf, got);
    int cap_ok = 1;
    if(getenv("OPENAL_TPU_ALSA_LIB")) {
        /* fake libasound serves a frame-index ramp */
        for(int i = 0; i < got; ++i)
            if(cbuf[i] != (short)i) { cap_ok = 0; break; }
        if(got < 64) cap_ok = 0;
    }
    if(!cap_ok) { fprintf(stderr, "capture data\n"); return 1; }
    alcCaptureStop(cap);
    alcCaptureCloseDevice(cap);

    /* --- scenario 6: callback-buffer streaming (AL_SOFT_callback_buffer) */
    {
        unsigned cbuf2, csrc;
        alGenBuffers(1, &cbuf2);
        alGenSources(1, &csrc);
        alBufferCallbackSOFT(cbuf2, AL_FORMAT_MONO_FLOAT32, RATE,
                             tone_callback, NULL);
        void *fn = NULL, *user = (void*)&cbuf2;
        alGetBufferPtrSOFT(cbuf2, 0x19A0, &fn);   /* CALLBACK_FUNCTION */
        alGetBufferPtrSOFT(cbuf2, 0x19A1, &user); /* CALLBACK_USER_PARAM */
        if(fn != (void*)tone_callback || user != NULL) {
            fprintf(stderr, "callback ptr query\n");
            return 1;
        }
        alSourcei(csrc, AL_BUFFER, (int)cbuf2);
        alSourcePlay(csrc);
        float cpeak = 0.0f;
        for(int blocks = 0; blocks < 4; ++blocks) {
            alcRenderSamplesSOFT(dev, out, FRAMES);
            float p = peak_of(out, FRAMES * 2);
            if(p < 0.0f) { fprintf(stderr, "NaN in callback stream\n"); return 1; }
            if(p > cpeak) cpeak = p;
        }
        if(cpeak <= 0.01f) {
            fprintf(stderr, "silent callback stream (peak %f)\n", cpeak);
            return 1;
        }
        if(g_cb_calls <= 0) {
            fprintf(stderr, "callback never pulled\n");
            return 1;
        }
        alSourceStop(csrc);
        alDeleteSources(1, &csrc);
        alDeleteBuffers(1, &cbuf2);
        printf("CB_PEAK=%.6f CB_CALLS=%d\n", cpeak, g_cb_calls);
    }

    printf("PEAK=%.6f STREAM_PEAK=%.6f CAPTURED=%d EAX_DECAY=%.3f\n",
           peak, speak, got, decay);
    return 0;
}
